"""The write-error draw (``kernels.ber_draw``, ``ops.ber_draw_op``).

On the CPU: the op equals ``prng.split`` plus ``ber.write_error_bits`` (the
plain chain, held to ``jax.random`` by ``test_torch_prng``) on keys and
masks; a numpy model of the kernel's arithmetic (``csrc/ber_draw.cu``: its
injection schedule, rotations, counters and float32 compare) equals the
chain too; the detector step draws through the op once per chunk iff it
injects, and backend ``"torch"`` never calls it.  On the card (marked
``cuda``, skips here): the kernel against the plain chain, bit for bit.
This module imports no jax.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import ber as t_ber  # noqa: E402
from repro_torch.core import hwmodel  # noqa: E402
from repro_torch.core import pipeline  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core import state as t_state  # noqa: E402
from repro_torch.kernels import ber_draw, fused_step, ops  # noqa: E402

BER_06, BER_08 = hwmodel.ber_at(0.6), hwmodel.ber_at(0.8)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _keys(seeds, device="cpu"):
    return torch.stack([prng.prng_key(s, device=device) for s in seeds])


def _chain(key, shape, ber):
    key, sub = prng.split(key)
    return key, t_ber.write_error_bits(sub, shape, ber)


# --- a numpy model of the kernel's arithmetic ------------------------------

def _rotl(x, r):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def _threefry(k1, k2, x1, x2):
    """``threefry2x32`` as the kernel spells it: the five injections
    written out, uint32 wrap-around arithmetic."""
    k3 = k1 ^ k2 ^ np.uint32(0x1BD11BDA)
    x1, x2 = x1 + k1, x2 + k2
    inject = ((k2, k3, 1), (k3, k1, 2), (k1, k2, 3), (k2, k3, 4),
              (k3, k1, 5))
    for i, (a, b, c) in enumerate(inject):
        for r in ((13, 15, 26, 6), (17, 29, 16, 24))[i % 2]:
            x1 = x1 + x2
            x2 = _rotl(x2, r) ^ x1
        x1, x2 = x1 + a, x2 + b + np.uint32(c)
    return x1, x2


def _kernel_model(key, shape, ber):
    """One lane at a time, one pixel a thread: the new key, the sub key,
    counter ``5p + b`` split into (hi, lo), ``float(bits >> 9) * 2^-23 <
    rate`` in float32, the five flips packed into an int32."""
    key = key.numpy().astype(np.uint32)
    rate = ber.numpy().astype(np.float32)
    hw = shape[0] * shape[1]
    new_key = np.zeros(key.shape, np.int64)
    masks = np.zeros((key.shape[0], hw), np.int32)
    with np.errstate(over="ignore"):
        for lane, (k1, k2) in enumerate(key):
            zero, one = np.uint32(0), np.uint32(1)
            new_key[lane] = _threefry(k1, k2, zero, zero)
            s1, s2 = _threefry(k1, k2, zero, one)
            p = np.arange(hw, dtype=np.uint64)
            for b in range(5):
                n = np.uint64(5) * p + np.uint64(b)
                x1, x2 = _threefry(s1, s2, (n >> np.uint64(32)).astype(
                    np.uint32), (n & np.uint64(0xFFFFFFFF)).astype(np.uint32))
                u = ((x1 ^ x2) >> np.uint32(9)).astype(np.float32) \
                    * np.float32(2.0 ** -23)
                masks[lane] |= (u < rate[lane]).astype(np.int32) << b
    return (torch.from_numpy(new_key),
            torch.from_numpy(masks.reshape(-1, *shape)))


@pytest.mark.parametrize("shape", [(1, 1), (12, 17), (40, 56), (3, 257)])
@pytest.mark.parametrize("rates", [(0.025,), (0.0, 0.002, 0.025, 0.5),
                                   (BER_06, BER_08, BER_06, BER_08)])
def test_op_equals_chain_and_kernel_model(shape, rates):
    """``ops.ber_draw_op`` on the CPU, the plain chain and the kernel's
    arithmetic: the same new keys and masks, exactly; the key is left as
    it was and the call is counted, not launched."""
    seeds = [7, -3, 2**31 - 1, 123456][:len(rates)]
    key = _keys(seeds)
    before = key.clone()
    ber = torch.tensor(rates, dtype=torch.float32)
    calls, launches = ops.CALLS["ber_draw"], ops.LAUNCHES["ber_draw"]
    got_key, got_bits = ops.ber_draw_op(key, shape, ber)
    assert ops.CALLS["ber_draw"] == calls + 1
    assert ops.LAUNCHES["ber_draw"] == launches
    assert torch.equal(key, before)
    want_key, want_bits = _chain(key, shape, ber)
    model_key, model_bits = _kernel_model(key, shape, ber)
    assert got_bits.dtype == torch.int32
    assert got_bits.shape == (len(rates), *shape)
    for got, want in ((got_key, want_key), (got_bits, want_bits),
                      (model_key, want_key), (model_bits, want_bits)):
        assert torch.equal(got, want)
    if 0.0 in rates:
        assert not got_bits[rates.index(0.0)].any()


def test_op_chains_keys_as_the_plain_split():
    """Four draws in a row: each new key feeds the next, as the step
    carries it; keys and masks equal the chain's at every draw."""
    key = want = _keys([0, 1, 2])
    ber = torch.tensor([BER_06, BER_08, 0.002], dtype=torch.float32)
    for _ in range(4):
        key, bits = ops.ber_draw_op(key, (9, 14), ber)
        want, want_bits = _chain(want, (9, 14), ber)
        assert torch.equal(key, want)
        assert torch.equal(bits, want_bits)


def _cfg(backend, inject_ber):
    return pipeline.PipelineConfig(height=24, width=32, chunk=64,
                                   lut_every_chunks=2, vdd=0.6,
                                   inject_ber=inject_ber, backend=backend,
                                   device="cpu")


def _stream(rng, n, h, w):
    xy = np.stack([rng.integers(0, w, n), rng.integers(0, h, n)], -1)
    return xy.astype(np.int32), np.sort(rng.integers(0, 40_000, n))


@pytest.mark.parametrize("backend", ["fused", "nmc", "batched", "torch"])
@pytest.mark.parametrize("inject_ber", [True, False])
def test_step_draws_through_op_once_per_chunk(backend, inject_ber):
    """``run_pipeline_batched`` (``detector_scan``, ``detector_step_``):
    one op call per chunk iff injecting, none on ``"torch"``."""
    rng = np.random.default_rng(5)
    xy, ts = _stream(rng, 300, 24, 32)
    ops.reset_launch_counts()
    res = pipeline.run_pipeline_batched(
        np.stack([xy, xy[::-1]]), np.stack([ts, ts]),
        _cfg(backend, inject_ber), seeds=[3, 4])
    chunks = len(res[0].vdd_trace)
    assert chunks == 5
    drawn = chunks if inject_ber and backend != "torch" else 0
    assert ops.CALLS["ber_draw"] == drawn


@pytest.mark.parametrize("backend", ["fused", "torch"])
def test_step_with_lanes_at_06_and_08_volts(backend):
    """One step of four lanes, two at 0.6 V and two at 0.8 V, one lane
    masked off: the active lanes' new keys are the plain split's, the
    masked lane keeps its key, and the surfaces equal the plain chunk block
    fed the plain chain's bits."""
    rng = np.random.default_rng(11)
    cfg = _cfg(backend, True)
    b, h, w, e = 4, cfg.height, cfg.width, cfg.chunk
    state = t_state.detector_init(cfg, seed=[5, 6, 7, 8], device="cpu")
    hot = rng.random((b, h, w)) < 0.4
    surface = np.where(hot, rng.integers(225, 256, (b, h, w)), 0)
    state = state._replace(surface=torch.as_tensor(surface, dtype=torch.uint8))
    xy = np.stack([_stream(rng, e, h, w)[0] for _ in range(b)])
    ts = np.sort(rng.integers(0, 4_000, (b, e)), axis=1)
    ber = torch.tensor([BER_06, BER_08, BER_06, BER_08])
    chunk = t_state.ChunkInput(
        xy=torch.as_tensor(xy), ts=torch.as_tensor(ts, dtype=torch.int32),
        valid=torch.ones((b, e), dtype=torch.bool), ber=ber,
        energy_coef=torch.zeros(b), latency_coef=torch.zeros(b))
    mask = np.array([True, True, False, True])
    new, _ = t_state.detector_step(cfg, state, chunk, mask)
    want_key, bits = _chain(state.key, (h, w), ber)
    assert torch.equal(new.key[mask], want_key[mask])
    assert torch.equal(new.key[~mask], state.key[~mask])
    tos = fused_step.fused_step_ref(
        state.surface, state.sae, state.lut, chunk.xy, chunk.ts,
        chunk.valid, ber, bits, mask=torch.as_tensor(mask), patch=cfg.patch,
        th=cfg.th, support=cfg.stcf_support, tw=cfg.stcf_tw_us,
        stcf_enabled=cfg.stcf_enabled,
        update=t_state._plain_update(cfg))[0]
    assert torch.equal(new.surface, tos)
    assert bits[0].any() and not bits[1].any()   # flips at 0.6 V only


def test_cuda_launcher_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        ber_draw.ber_draw_cuda(_keys([1]), (4, 4), torch.zeros(1))


# --- on the card ------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU build)")
    return torch.device("cuda")


_RATES = {
    "0": [0.0] * 4,
    "0.002": [0.002] * 4,
    "0.025": [0.025] * 4,
    "0.6V+0.8V": [BER_06, BER_08, BER_08, BER_06],
}


@pytest.mark.cuda
@pytest.mark.parametrize("rates", list(_RATES))
@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("shape", [(180, 240), (720, 1280)])
def test_kernel_equals_plain_on_card(cuda, shape, b, rates):
    """The kernel's new keys and masks equal the plain chain's on the card
    (``==``), over three draws whose keys chain, the first from a strided
    key as the plain split leaves it; one launch a draw."""
    ber = torch.tensor(_RATES[rates][:b], dtype=torch.float32, device=cuda)
    key = prng.split(_keys([2**31 - 1, 0, -7, 99][:b], cuda))[0]
    want = key
    for _ in range(3):
        launches = ops.LAUNCHES["ber_draw"]
        key, bits = ops.ber_draw_op(key, shape, ber)
        assert ops.LAUNCHES["ber_draw"] == launches + 1
        want, want_bits = _chain(want, shape, ber)
        torch.cuda.synchronize()
        assert torch.equal(key, want)
        assert torch.equal(bits, want_bits)
    if rates == "0.025":
        assert bits.any()
