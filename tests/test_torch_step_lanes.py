"""The step's per-lane scalar chains (``kernels.step_lanes``,
``ops.dvfs_pick_op``, ``ops.step_books_op``).

On the CPU: the pick equals the JAX reference's online estimator
(``repro.core.dvfs.online_vdd_from_chunk_ts``), its cap, the reference
pool's lane-mask select and the operating-point gathers, jitted and mapped
over the lanes; the books equal the reference's jitted ``acc + n * coef``
(one FMA) and kept count.  Cases: window offsets and spans, negative
chunk-relative times, lanes with no valid event, saturated counters,
uniform and per-lane caps, masks with no, some and all lanes active, E in
{128, 512, 2048} and B in {1, 4, 16}.  The detector step calls each op
once a chunk on the kernel backends, never on ``"torch"``.  On the card
(marked ``cuda``, skips here): the kernels against the plain versions bit
for bit on the same cases, an HD x4 pool and a DAVIS240 x16 adaptive pool
against backend ``"torch"``, and one launch each a step.  The JAX
reference is imported inside the CPU tests only, so this module also runs
on a GPU host without it.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import dvfs as t_dvfs  # noqa: E402
from repro_torch.core import pipeline  # noqa: E402
from repro_torch.core import state as t_state  # noqa: E402
from repro_torch.events import synthetic  # noqa: E402
from repro_torch.kernels import ops, step_lanes  # noqa: E402
from repro_torch.obs.schema import WALL_TIME_KEYS  # noqa: E402
from repro_torch.serve import DetectorPool  # noqa: E402

SAT = (1 << 20) - 1
SHAPES = [(b, e) for b in (1, 4, 16) for e in (128, 512, 2048)]
CAPS = ["none", "uniform", "per-lane"]
MASKS = ["none", "all", "some", "no lanes"]
OFFSETS = [0, 1, 2, 3, 9]       # d = w_first - win (>= 3: nothing carried)
SPANS = [0, 1, 2, 3]            # e = w_last - w_first


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- cases -----------------------------------------------------------------

def _lane_events(rng, e, half, w_first, span, kind):
    """One lane's chunk: sorted times from half-window ``w_first`` to
    ``w_first + span`` (the first and last event in those two), and a valid
    mask of ``kind``."""
    first = w_first * half + int(rng.integers(0, half))
    last = (w_first + span) * half + int(rng.integers(0, half))
    last = max(last, first)
    ts = np.sort(rng.integers(first, last + 1, e))
    ts[0], ts[-1] = first, last
    if kind == "all":
        valid = np.ones(e, bool)
    elif kind == "none":
        valid = np.zeros(e, bool)
    elif kind == "prefix":
        valid = np.arange(e) < int(rng.integers(1, e + 1))
    else:
        valid = rng.random(e) < 0.7
    return ts.astype(np.int32), valid


def _counters(rng, kind):
    """A lane's (cur, prev1, prev2): log-uniform up to 2^21 (picks across
    the table), at the saturation, above it, or zero."""
    if kind == "sat":
        return [SAT] * 3
    if kind == "over":
        return [SAT + 17, SAT + 1, SAT]
    if kind == "zero":
        return [0] * 3
    return [int(2 ** rng.uniform(0, 21)) for _ in range(3)]


def pick_case(seed, b, e, half, *, offset=None, span=None):
    """``(rate (4, B), ts (B, E), valid (B, E))`` numpy arrays; lanes cycle
    through negative and positive first windows, the valid kinds and the
    counter kinds; ``offset`` / ``span`` fix d and e for every lane."""
    rng = np.random.default_rng(seed)
    rate = np.zeros((4, b), np.int32)
    ts = np.zeros((b, e), np.int32)
    valid = np.zeros((b, e), bool)
    kinds = ("random", "all", "prefix", "random", "none")
    counts = ("log", "log", "sat", "log", "over", "zero")
    for i in range(b):
        w_first = int(rng.integers(-6, 0) if i % 3 == 0
                      else rng.integers(0, 40))
        d = int(rng.choice([0, 1, 2, 3, 9, -2])) if offset is None else offset
        s = int(rng.integers(0, 5)) if span is None else span
        ts[i], valid[i] = _lane_events(rng, e, half, w_first, s,
                                       kinds[i % len(kinds)])
        rate[:, i] = [w_first - d, *_counters(rng, counts[i % len(counts)])]
    return rate, ts, valid


def caps_for(kind, b, p, seed=0):
    """The host caps of ``kind`` (an int32 row) and a function of the
    device giving the op's ``cap`` (None, an int, or a row there)."""
    rng = np.random.default_rng(seed)
    if kind == "none":
        row = np.full(b, p - 1, np.int32)
    elif kind == "uniform":
        row = np.full(b, 1, np.int32)
    else:
        row = rng.integers(-1, p, b).astype(np.int32)
        row[0] = 0
    return row, (lambda dev: None if kind == "none" else
                 int(row[0]) if kind == "uniform" else
                 torch.as_tensor(row, device=dev))


def mask_for(kind, b, seed=0):
    """The host lane mask of ``kind`` and a function of the device giving
    the op's ``mask`` (None, or a bool row there)."""
    if kind in ("none", "all"):
        row = np.ones(b, bool)
    elif kind == "no lanes":
        row = np.zeros(b, bool)
    else:
        row = np.random.default_rng(seed).random(b) < 0.5
        row[0] = not row[-1] if b > 1 else True
    return row, (lambda dev: None if kind == "none" else
                 torch.as_tensor(row, device=dev))


def books_case(seed, b, e):
    """``(keep (B, E), kept_total, energy_pj, latency_ns, energy_coef,
    latency_coef)`` numpy arrays: keep densities from 0 to 1, books at
    which one rounding often differs from two."""
    rng = np.random.default_rng(seed)
    keep = rng.random((b, e)) < rng.random((b, 1))
    keep[0] = False
    kept_total = rng.integers(0, 2**30, b).astype(np.int32)
    energy = (rng.random(b) * 1e3).astype(np.float32)
    latency = (rng.random(b) * 1e5).astype(np.float32)
    tab = t_dvfs.op_point_table(t_dvfs.DvfsConfig())
    pts = rng.integers(0, len(tab.caps), b)
    return (keep, kept_total, energy, latency, tab.energy_pj[pts],
            tab.latency_ns[pts])


# --- the JAX reference -----------------------------------------------------

_JAX_FNS = {}


@pytest.fixture
def jref():
    """The JAX reference's pick and books, jitted and mapped over lanes."""
    jax = pytest.importorskip("jax")
    jnp = pytest.importorskip("jax.numpy")
    j_dvfs = pytest.importorskip("repro.core.dvfs")
    if not _JAX_FNS:
        def pick(cfg):
            tab = j_dvfs.op_point_table(cfg)

            def one(rate, ts, valid, cap, active):
                new, idx = j_dvfs.online_vdd_from_chunk_ts(
                    rate, ts, valid, cfg=cfg, caps=jnp.asarray(tab.caps))
                idx = jnp.minimum(idx, cap)
                new = jax.tree.map(lambda n, o: jnp.where(active, n, o),
                                   new, rate)
                return (new, idx, jnp.asarray(tab.ber)[idx],
                        jnp.asarray(tab.energy_pj)[idx],
                        jnp.asarray(tab.latency_ns)[idx])
            return jax.jit(jax.vmap(one))

        def books(keep, kept_total, energy, latency, e_coef, l_coef,
                  active):
            n_kept = jnp.sum(keep).astype(jnp.int32)
            new = (kept_total + n_kept,
                   energy + n_kept.astype(jnp.float32) * e_coef,
                   latency + n_kept.astype(jnp.float32) * l_coef)
            old = (kept_total, energy, latency)
            return (n_kept, *(jnp.where(active, n, o)
                              for n, o in zip(new, old)))

        _JAX_FNS.update(pick=pick, books=jax.jit(jax.vmap(books)),
                        cfg=j_dvfs.DvfsConfig, rate=j_dvfs.RateState)
    return _JAX_FNS


def _jax_pick(jref, tw_us, rate, ts, valid, caps, active):
    cfg = jref["cfg"](tw_us=tw_us)
    key = ("pick", tw_us)
    if key not in jref:
        jref[key] = jref["pick"](cfg)
    new, *rest = jref[key](jref["rate"](*rate), ts, valid, caps, active)
    return [np.asarray(x) for x in (*new, *rest)]


def _torch_pick(fn, tw_us, rate, ts, valid, cap, mask, dev="cpu"):
    new, *rest = fn(
        t_dvfs.RateState(*(torch.as_tensor(r, device=dev) for r in rate)),
        torch.as_tensor(ts, device=dev), torch.as_tensor(valid, device=dev),
        cfg=t_dvfs.DvfsConfig(tw_us=tw_us), cap=cap, mask=mask)
    return [*new, *rest]


def _assert_exact(got, want, names):
    for g, w, name in zip(got, want, names):
        g = g.cpu().numpy() if torch.is_tensor(g) else g
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


PICK_OUT = ("win", "cur", "prev1", "prev2", "vdd_idx", "ber", "energy_coef",
            "latency_coef")
BOOKS_OUT = ("n_kept", "kept_total", "energy_pj", "latency_ns")


# --- a numpy model of the kernels' arithmetic ------------------------------

def _wrap(x):
    """int64 values as the int32 the kernel's wrapping adds leave."""
    return (np.asarray(x, np.int64) + 2**31) % 2**32 - 2**31


def _floor_div(a, b):
    """The kernel's ``floor_div``: C's truncating divide, one down for a
    negative quotient with a remainder."""
    a = np.asarray(a, np.int64)
    q = np.sign(a) * (np.abs(a) // b)
    return np.where((a < 0) & (q * b != a), q - 1, q)


def pick_model(rate, ts, valid, table, cap_row, cap, mask, half, sat,
               inv_tw, headroom):
    """``dvfs_pick_kernel`` one lane at a time, as ``csrc/step_lanes.cu``
    spells it; returns ``(out_i (5, B), out_f (3, B))``."""
    b, e = ts.shape
    p = table.shape[1]
    out_i = np.zeros((5, b), np.int32)
    out_f = np.zeros((3, b), np.float32)
    for lane in range(b):
        t, v = ts[lane].astype(np.int64), valid[lane]
        w_last = int(_floor_div(t[e - 1], half))
        w = _floor_div(t, half)
        c = [int(v.sum())] + [int((v & (w == _wrap(w_last - k))).sum())
                              for k in range(3)]
        o_win, o_cur, o_p1, o_p2 = (int(r[lane]) for r in rate)
        w_first = int(_floor_div(t[0], half))
        d = int(_wrap(w_first - o_win))
        r_cur = o_cur if d == 0 else 0
        r_p1 = o_p1 if d == 0 else o_cur if d == 1 else 0
        r_p2 = o_p2 if d == 0 else o_p1 if d == 1 else o_cur if d == 2 else 0
        pair = int(_wrap(min(r_p1, sat) + min(r_p2, sat)))
        need = np.float32(np.float32(np.float32(pair) * np.float32(inv_tw))
                          * np.float32(headroom))
        idx = next((i for i in range(p) if table[0, i] >= need), p - 1)
        idx = min(idx, int(cap_row[lane]) if cap_row is not None else cap)
        g = max(idx + p if idx < 0 else idx, 0)
        sp = int(_wrap(w_last - w_first))
        old = c[0] == 0 or (mask is not None and not mask[lane])
        new = (w_last, _wrap(c[1] + (r_cur if sp == 0 else 0)),
               _wrap(c[2] + (r_p1 if sp == 0 else r_cur if sp == 1 else 0)),
               _wrap(c[3] + (r_p2 if sp == 0 else r_p1 if sp == 1
                             else r_cur if sp == 2 else 0)))
        out_i[:4, lane] = (o_win, o_cur, o_p1, o_p2) if old else new
        out_i[4, lane] = idx
        out_f[:, lane] = table[1:, g]
    return out_i, out_f


def books_model(keep, kept_total, energy, latency, e_coef, l_coef, mask):
    """``step_books_kernel`` as the source spells it: the kept count, a
    wrapping int32 add, and each book as one float64 multiply and one add
    rounded once to float32; masked-off lanes keep their books."""
    nk = keep.sum(-1).astype(np.int64)
    active = np.ones(len(nk), bool) if mask is None else mask

    def book(acc, coef):
        one = (acc.astype(np.float64) + nk * coef.astype(np.float64))
        return np.where(active, one.astype(np.float32), acc)

    return (nk.astype(np.int32),
            np.where(active, _wrap(kept_total + nk), kept_total).astype(
                np.int32),
            book(energy, e_coef), book(latency, l_coef))


# --- on the CPU: the ops against the JAX reference -------------------------

@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("cap_kind", CAPS)
@pytest.mark.parametrize("b,e", SHAPES)
def test_pick_equals_jax_reference(jref, b, e, cap_kind, mask_kind):
    """``ops.dvfs_pick_op`` on the CPU (the plain version) equals the
    reference's pick at the cells' 10 ms window, output for output, and
    leaves its inputs alone; counted as a call, not a launch."""
    tw = 10_000
    rate, ts, valid = pick_case(b * 7919 + e, b, e, tw // 2)
    caps, cap = caps_for(cap_kind, b, 7, seed=e)
    active, mask = mask_for(mask_kind, b, seed=e)
    want = _jax_pick(jref, tw, rate, ts, valid, caps, active)
    calls, launches = ops.CALLS["dvfs_pick"], ops.LAUNCHES["dvfs_pick"]
    got = _torch_pick(ops.dvfs_pick_op, tw, rate, ts, valid, cap("cpu"),
                      mask("cpu"))
    assert ops.CALLS["dvfs_pick"] == calls + 1
    assert ops.LAUNCHES["dvfs_pick"] == launches
    _assert_exact(got, want, PICK_OUT)
    if mask_kind == "no lanes":
        _assert_exact(got[:4], list(rate), PICK_OUT)


@pytest.mark.parametrize("span", SPANS)
@pytest.mark.parametrize("offset", OFFSETS)
def test_pick_window_cases_equal_jax_reference(jref, offset, span):
    """Every lane at window offset d and span e (half-windows of 100 us, so
    a chunk crosses several), over negative and positive times, lanes with
    no valid event and saturated counters: the pick equals the
    reference's; the picks spread over the table."""
    b, e, tw = 16, 128, 200
    rate, ts, valid = pick_case(31 * offset + span, b, e, tw // 2,
                                offset=offset, span=span)
    caps, _ = caps_for("none", b, 7)
    active = np.ones(b, bool)
    want = _jax_pick(jref, tw, rate, ts, valid, caps, active)
    got = _torch_pick(ops.dvfs_pick_op, tw, rate, ts, valid, None, None)
    _assert_exact(got, want, PICK_OUT)
    assert (ts < 0).any() and not valid.all(1).all()


@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("b,e", SHAPES)
def test_books_equal_jax_reference(jref, b, e, mask_kind):
    """``ops.step_books_op`` on the CPU equals the reference's kept count,
    kept total and jitted ``acc + n * coef`` (one rounding), with the
    reference pool's select for inactive lanes."""
    case = books_case(b * 31 + e, b, e)
    active, mask = mask_for(mask_kind, b, seed=b)
    want = [np.asarray(x) for x in jref["books"](*case, active)]
    calls = ops.CALLS["step_books"]
    got = ops.step_books_op(*(torch.as_tensor(x) for x in case),
                            mask("cpu"))
    assert ops.CALLS["step_books"] == calls + 1
    _assert_exact(got, want, BOOKS_OUT)


def test_books_round_once_as_the_reference(jref):
    """256 lanes: the books equal the reference's FMA where a float32
    product then add, rounded twice, differs."""
    case = books_case(7, 256, 512)
    want = [np.asarray(x) for x in jref["books"](*case, np.ones(256, bool))]
    got = ops.step_books_op(*(torch.as_tensor(x) for x in case))
    _assert_exact(got, want, BOOKS_OUT)
    nk = case[0].sum(-1).astype(np.float32)
    assert (case[2] + nk * case[4] != want[2]).sum() > 10
    assert (case[3] + nk * case[5] != want[3]).sum() > 10


@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("cap_kind", CAPS)
@pytest.mark.parametrize("b,e", SHAPES)
def test_pick_kernel_model_equals_plain(b, e, cap_kind, mask_kind):
    """The numpy model of ``dvfs_pick_kernel``'s arithmetic (its floor
    divide, wrapping adds, two float32 multiplies, first-fit scan, cap and
    the lane mask) equals the plain version on the CPU test's cases."""
    tw = 10_000
    cfg = t_dvfs.DvfsConfig(tw_us=tw)
    rate, ts, valid = pick_case(b * 7919 + e, b, e, tw // 2)
    caps, cap = caps_for(cap_kind, b, 7, seed=e)
    active, mask = mask_for(mask_kind, b, seed=e)
    want = _torch_pick(step_lanes.dvfs_pick_ref, tw, rate, ts, valid,
                       cap("cpu"), mask("cpu"))
    table = step_lanes.op_table(cfg, torch.device("cpu"))["packed"].numpy()
    out_i, out_f = pick_model(
        rate, ts, valid, table, caps if cap_kind == "per-lane" else None,
        int(caps[0]), None if mask_kind == "none" else active,
        cfg.half_us, SAT, np.float32(1.0) / np.float32(tw), cfg.headroom)
    _assert_exact(want, [*out_i, *out_f], PICK_OUT)


@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("b,e", SHAPES)
def test_books_kernel_model_equals_plain(b, e, mask_kind):
    """The numpy model of ``step_books_kernel`` equals the plain version."""
    case = books_case(b * 31 + e, b, e)
    active, mask = mask_for(mask_kind, b, seed=b)
    want = step_lanes.step_books_ref(*(torch.as_tensor(x) for x in case),
                                     mask("cpu"))
    got = books_model(*case, None if mask_kind == "none" else active)
    _assert_exact(want, list(got), BOOKS_OUT)


def _cfg(backend, online, inject_ber=True):
    return pipeline.PipelineConfig(height=24, width=32, chunk=64,
                                   lut_every_chunks=2, dvfs=online,
                                   dvfs_online=online, vdd=0.6,
                                   inject_ber=inject_ber, backend=backend,
                                   device="cpu")


@pytest.mark.parametrize("backend", ["fused", "nmc", "batched", "torch"])
@pytest.mark.parametrize("online", [True, False])
def test_step_calls_each_op_once_per_chunk(backend, online):
    """``run_pipeline_batched`` (``detector_scan``, ``detector_step_``):
    one pick a chunk iff online, one books call a chunk, on the kernel
    backends; none on ``"torch"``, which keeps the plain chains."""
    rng = np.random.default_rng(5)
    xy = np.stack([rng.integers(0, 32, 300), rng.integers(0, 24, 300)], -1)
    ts = np.sort(rng.integers(0, 40_000, 300))
    ops.reset_launch_counts()
    res = pipeline.run_pipeline_batched(
        np.stack([xy, xy[::-1]]).astype(np.int32), np.stack([ts, ts]),
        _cfg(backend, online), seeds=[3, 4])
    chunks = len(res[0].vdd_trace)
    assert chunks == 5
    kernels = backend != "torch"
    assert ops.CALLS["dvfs_pick"] == (chunks if kernels and online else 0)
    assert ops.CALLS["step_books"] == (chunks if kernels else 0)


@pytest.mark.parametrize("backend", ["fused", "torch"])
def test_masked_step_keeps_inactive_lanes(backend):
    """A step of four lanes with one masked off: the masked lane keeps its
    estimator, books, key and cursor; the others' estimator and books
    equal the plain chains' on the same inputs."""
    cfg = _cfg(backend, True)
    b, e = 4, cfg.chunk
    rng = np.random.default_rng(9)
    state = t_state.detector_init(cfg, seed=[5, 6, 7, 8], device="cpu")
    rate, ts, valid = pick_case(3, b, e, cfg.dvfs_cfg.half_us)
    state = state._replace(
        rate=t_dvfs.RateState(*(torch.as_tensor(r) for r in rate)),
        kept_total=torch.tensor([1, 2, 3, 4], dtype=torch.int32),
        energy_pj=torch.tensor([10.5, 0.0, 3.25, 7.0]),
        latency_ns=torch.tensor([1.0, 2.0, 3.0, 4.0]))
    xy = np.stack([rng.integers(0, cfg.width, (b, e)),
                   rng.integers(0, cfg.height, (b, e))], -1)
    chunk = t_state.ChunkInput(
        xy=torch.as_tensor(xy, dtype=torch.int32), ts=torch.as_tensor(ts),
        valid=torch.as_tensor(valid), ber=torch.zeros(b),
        energy_coef=torch.zeros(b), latency_coef=torch.zeros(b))
    mask = np.array([True, False, True, True])
    new, out = t_state.detector_step(cfg, state, chunk, mask)
    m = torch.as_tensor(mask)
    want = step_lanes.dvfs_pick_ref(state.rate, chunk.ts, chunk.valid,
                                    cfg=cfg.dvfs_cfg, mask=m)
    for got, w in zip(new.rate, want[0]):
        assert torch.equal(got, w)
    assert torch.equal(out.vdd_idx, want[1])
    books = step_lanes.step_books_ref(
        out.keep, state.kept_total, state.energy_pj, state.latency_ns,
        want[3], want[4], m)
    for got, w in zip((out.n_kept, new.kept_total, new.energy_pj,
                       new.latency_ns), books):
        assert torch.equal(got, w)
    for leaf in ("kept_total", "energy_pj", "latency_ns", "key"):
        assert torch.equal(getattr(new, leaf)[1], getattr(state, leaf)[1])
    for r_new, r_old in zip(new.rate, state.rate):
        assert r_new[1] == r_old[1]
    assert list(new.chunk_idx) == [1, 0, 1, 1]


def test_step_refuses_a_cap_below_the_table():
    cfg = _cfg("fused", True)
    state = t_state.detector_init(cfg, seed=[1, 2], device="cpu")
    state = state._replace(ctrl=state.ctrl._replace(
        vdd_cap=np.array([-8, 0], np.int32)))
    rate, ts, valid = pick_case(1, 2, cfg.chunk, cfg.dvfs_cfg.half_us)
    chunk = t_state.ChunkInput(
        xy=torch.zeros((2, cfg.chunk, 2), dtype=torch.int32),
        ts=torch.as_tensor(ts), valid=torch.as_tensor(valid),
        ber=torch.zeros(2), energy_coef=torch.zeros(2),
        latency_coef=torch.zeros(2))
    with pytest.raises(ValueError, match="below"):
        t_state.detector_step(cfg, state, chunk)


def test_cuda_launchers_refuse_cpu_tensors():
    rate, ts, valid = pick_case(0, 2, 8, 5000)
    with pytest.raises(ValueError, match="CUDA"):
        _torch_pick(step_lanes.dvfs_pick_cuda, 10_000, rate, ts, valid,
                    None, None)
    case = [torch.as_tensor(x) for x in books_case(0, 2, 8)]
    with pytest.raises(ValueError, match="CUDA"):
        step_lanes.step_books_cuda(*case)


# --- on the card ------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU build)")
    return torch.device("cuda")


def _pick_on_card(dev, tw, case, cap, mask):
    """The kernel's and the plain version's pick of ``case`` on the card;
    one launch, inputs left alone."""
    rate, ts, valid = case
    launches = ops.LAUNCHES["dvfs_pick"]
    got = _torch_pick(ops.dvfs_pick_op, tw, rate, ts, valid, cap, mask, dev)
    assert ops.LAUNCHES["dvfs_pick"] == launches + 1
    want = _torch_pick(step_lanes.dvfs_pick_ref, tw, rate, ts, valid, cap,
                       mask, dev)
    torch.cuda.synchronize()
    for g, w, name in zip(got, want, PICK_OUT):
        assert g.dtype == w.dtype and torch.equal(g, w), name
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("cap_kind", CAPS)
@pytest.mark.parametrize("b,e", SHAPES)
def test_pick_kernel_equals_plain_on_card(cuda, b, e, cap_kind, mask_kind):
    """The pick kernel equals the plain version on the card, bit for bit,
    at every shape, cap and mask."""
    case = pick_case(b * 7919 + e, b, e, 5000)
    _, cap = caps_for(cap_kind, b, 7, seed=e)
    _, mask = mask_for(mask_kind, b, seed=e)
    _pick_on_card(cuda, 10_000, case, cap(cuda), mask(cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("span", SPANS)
@pytest.mark.parametrize("offset", OFFSETS)
def test_pick_kernel_window_cases_on_card(cuda, offset, span):
    """The window offsets and spans of the CPU test, on the card."""
    case = pick_case(31 * offset + span, 16, 128, 100, offset=offset,
                     span=span)
    got = _pick_on_card(cuda, 200, case, None, None)
    if offset < 3:     # a carried pair: the picks spread over the table
        assert len(set(got[4].tolist())) > 1


@pytest.mark.cuda
@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("b,e", SHAPES)
def test_books_kernel_equals_plain_on_card(cuda, b, e, mask_kind):
    """The books kernel equals the plain version on the card, bit for bit;
    one launch."""
    case = [torch.as_tensor(x, device=cuda)
            for x in books_case(b * 31 + e, b, e)]
    _, mask = mask_for(mask_kind, b, seed=b)
    launches = ops.LAUNCHES["step_books"]
    got = ops.step_books_op(*case, mask(cuda))
    assert ops.LAUNCHES["step_books"] == launches + 1
    want = step_lanes.step_books_ref(*case, mask(cuda))
    torch.cuda.synchronize()
    for g, w, name in zip(got, want, BOOKS_OUT):
        assert g.dtype == w.dtype and torch.equal(g, w), name


def _serve_hd(backend, online=True, device="cuda"):
    """Four 1280x720 lanes (online DVFS with write errors, or fixed 0.6 V),
    chunk 512, three slabs of 4,096 events a lane."""
    cfg = pipeline.PipelineConfig(
        height=720, width=1280, chunk=512, lut_every_chunks=2, dvfs=online,
        dvfs_online=online, vdd=0.6, inject_ber=True, backend=backend,
        device=device)
    streams = [synthetic.shapes_stream(height=720, width=1280,
                                       duration_us=8_000, n_shapes=12,
                                       signal_rate_per_us=2.0,
                                       noise_rate_per_us=0.5, seed=s)
               for s in range(4)]
    pool = DetectorPool(cfg, 4, ring_rounds=8)
    lanes = [pool.connect(seed=s) for s in range(4)]
    outs = {i: [] for i in range(4)}
    for start in range(0, 3 * 4096, 4096):
        for i, lane in enumerate(lanes):
            pool.feed(lane, streams[i].xy[start:start + 4096],
                      streams[i].ts[start:start + 4096])
        pool.pump()
        for i, lane in enumerate(lanes):
            outs[i].append(pool.poll(lane))
    return _finish(pool, lanes, outs)


def _serve_davis_adaptive(backend, device="cuda"):
    """Sixteen DAVIS240 lanes on an adaptive pool over buckets 128/512/2048,
    ramps that move them, lane 1 shedding, lane 2 capped at 0.6 V."""
    cfg = pipeline.PipelineConfig(
        height=180, width=240, chunk=128, lut_every_chunks=2, dvfs=True,
        dvfs_online=True, inject_ber=True, backend=backend, device=device)
    half = cfg.dvfs_cfg.half_us
    rates = ([100] * 3 + [1500] * 5 + [400] * 4,
             [400] * 4 + [100] * 5 + [1500] * 3)
    streams = [synthetic.ramp_stream(rates[s % 2], half, seed=s)
               for s in range(16)]
    pool = DetectorPool(cfg, 16, ring_rounds=8, buckets=(128, 512, 2048),
                        policy="adaptive", migrate_patience=2)
    lanes = [pool.connect(seed=s, chunk=128) for s in range(16)]
    pool.set_lane_control(lanes[1], lut_every=3, shed=True)
    pool.set_lane_control(lanes[2], vdd_cap=0)
    outs = {i: [] for i in range(16)}
    for j in range(12):
        for i, lane in enumerate(lanes):
            m = (streams[i].ts // half) == j
            pool.feed(lane, streams[i].xy[m], streams[i].ts[m])
        pool.pump()
        for i, lane in enumerate(lanes):
            outs[i].append(pool.poll(lane))
    return _finish(pool, lanes, outs)


def _finish(pool, lanes, outs):
    for i, lane in enumerate(lanes):
        outs[i].append(pool.flush(lane))
    stats = [{k: v for k, v in pool.stats(lane).items()
              if k not in WALL_TIME_KEYS} for lane in lanes]
    pstats = pool.pool_stats()
    pool.close()
    return ({i: [np.concatenate(x) for x in zip(*o)]
             for i, o in outs.items()}, stats, pstats)


@pytest.mark.cuda
@pytest.mark.parametrize("serve", [_serve_hd, _serve_davis_adaptive],
                         ids=["hd720_x4", "davis240_x16_adaptive"])
def test_pools_with_kernels_equal_torch_backend_on_card(cuda, serve):
    """The cells' pools on the card, ``"fused"`` (the two kernels beside
    K1-K3 and the draw) against ``"torch"`` (every plain chain): per-lane
    scores and keep masks, and every lane's books, estimator read-outs and
    migrations equal; one pick and one books launch a step."""
    ops.reset_launch_counts()
    got, gstats, pstats = serve("fused")
    steps = ops.LAUNCHES["fused_step"]
    assert steps > 0
    assert ops.LAUNCHES["dvfs_pick"] == ops.LAUNCHES["step_books"] == steps
    assert ops.CALLS["dvfs_pick"] == steps
    want, wstats, _ = serve("torch")
    assert ops.LAUNCHES["dvfs_pick"] == ops.LAUNCHES["step_books"] == steps
    for i in want:
        for g, w in zip(got[i], want[i]):
            np.testing.assert_array_equal(g, w)
    assert gstats == wstats
    assert pstats["rounds_executed"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("online", [True, False])
def test_one_launch_each_a_step_on_card(cuda, online):
    """Every pool step launches one books kernel, and one pick iff online
    DVFS; fixed Vdd launches no pick."""
    ops.reset_launch_counts()
    _serve_hd("fused", online=online)
    steps = ops.LAUNCHES["fused_step"]
    assert steps > 0 and ops.LAUNCHES["step_books"] == steps
    assert ops.LAUNCHES["dvfs_pick"] == (steps if online else 0)
