"""The port's dry-run tools (``repro_torch.launch.{mesh,roofline}``,
``models.*.abstract_params`` / ``input_specs``,
``repro_torch.benchmarks.roofline_table``) held to the reference, with no
process group (the fake world runs in ``test_torch_dryrun_world.py``).

* ``HW`` holds the H100's rates of ``benchmarks/bounds.py`` and none of
  the reference's TPU v5e numbers.
* ``abstract_params`` (shapes, dtypes, logical axes) for the 10 full
  configs and ``input_specs`` for all 40 cells (skipped ones too) equal the
  reference's; ``count_params`` is equal (``==``) for the 10 configs and
  ``model_flops`` for the 40 cells.
* ``roofline_terms`` on the same ``HloStats`` values: each term times its
  H100 rate equals the reference's term times its v5e rate within 1e-12
  (relative); ``useful_ratio``, ``model_flops`` and the breakdown are equal,
  and ``dominant`` is the largest of the port's own terms.
* ``markdown_table(dir)`` and ``rows()`` equal the reference's
  ``benchmarks/roofline_table.py`` on the same records, written here.
* The MoE families (olmoe, deepseek) run ``forward_prefill`` and a train
  step on fake tensors: ``moe_dispatch`` has no shape that depends on the
  data.
"""
import json
import os
import sys

import jax
import pytest

from _torch_dryrun_harness import port_stats
from repro import configs as jconfigs
from repro.launch import mesh as JMESH
from repro.launch import roofline as JR
from repro.models import transformer as JT
from repro.utils.hlo_analysis import HloStats as JStats
from repro_torch import configs as tconfigs
from repro_torch.benchmarks import bounds
from repro_torch.benchmarks import roofline_table as TTAB
from repro_torch.launch import roofline as TR
from repro_torch.launch.mesh import HW
from repro_torch.models import transformer as TT
from repro_torch.utils.hlo_analysis import HloStats as TStats

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, ROOT)
from benchmarks import roofline_table as JTAB  # noqa: E402

CELLS = jconfigs.cells(include_skipped=True)
V5E = {197e12, 819e9, 50e9, 16 * 2**30, 16 * 2**20}


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], (*path, k))
    else:
        yield "/".join(path), tree


def _shapes(tree):
    """{path: (shape, dtype name)} of a JAX or port tree of abstract
    leaves."""
    return {p: (tuple(x.shape), str(x.dtype).replace("torch.", ""))
            for p, x in _flat(tree)}


def test_hw_holds_the_h100s_rates():
    assert HW.PEAK_BF16_FLOPS == bounds.TENSOR_FP16_FLOPS == 989e12
    assert HW.HBM_BW == bounds.MEM_BPS == 3.35e12
    assert HW.ICI_BW == bounds.ICI_BW == 450e9
    assert HW.HBM_BYTES == bounds.HBM_BYTES == 80e9
    assert HW.VMEM_BYTES == bounds.VMEM_BYTES == 228 * 1024
    names = ("PEAK_BF16_FLOPS", "HBM_BW", "ICI_BW", "HBM_BYTES",
             "VMEM_BYTES")
    assert all(hasattr(JMESH.HW, n) for n in names)
    values = {getattr(HW, n) for n in names} | {
        v for v in vars(bounds).values() if isinstance(v, (int, float))}
    assert not values & V5E


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_abstract_params_and_count_params_match(arch):
    jp, jax_axes = JT.abstract_params(jconfigs.get(arch))
    tp, t_axes = TT.abstract_params(tconfigs.get(arch))
    assert _shapes(tp) == _shapes(jp)
    assert all(x.device.type == "meta" for _, x in _flat(tp))
    jflat = dict(jax.tree_util.tree_flatten_with_path(
        jax_axes, is_leaf=lambda x: isinstance(x, tuple))[0])
    jflat = {"/".join(k.key for k in path): v for path, v in jflat.items()}
    assert dict(_flat_axes(t_axes)) == jflat
    assert TR.count_params(tconfigs.get(arch)) == JR.count_params(
        jconfigs.get(arch))


def _flat_axes(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat_axes(tree[k], (*path, k))
    else:
        yield "/".join(path), tree


@pytest.mark.parametrize("cell", CELLS,
                         ids=[f"{c['arch']}-{c['shape']}" for c in CELLS])
def test_input_specs_and_model_flops_match(cell):
    jc, tc = jconfigs.get(cell["arch"]), tconfigs.get(cell["arch"])
    kind, seq, gb = cell["kind"], cell["seq"], cell["batch"]
    j = JT.input_specs(jc, kind, seq, gb)
    t = TT.input_specs(tc, kind, seq, gb)
    assert _shapes(t) == _shapes(j)
    assert all(x.device.type == "meta" for _, x in _flat(t))
    assert TR.model_flops(tc, kind, seq, gb) == JR.model_flops(
        jc, kind, seq, gb)


STATS = [
    dict(collective_bytes={"all-gather": 3.5e9, "all-reduce": 1.25e8},
         dot_flops=7.7e14, hbm_bytes=2.1e12, n_collectives=96),
    dict(collective_bytes={"all-to-all": 9.0e10, "reduce-scatter": 4.0e9,
                           "collective-permute": 1.0e6},
         dot_flops=1.1e12, hbm_bytes=5.5e11, n_collectives=12),
    dict(collective_bytes={}, dot_flops=0.0, hbm_bytes=3.0e9,
         n_collectives=0),
]


@pytest.mark.parametrize("i", range(len(STATS)))
@pytest.mark.parametrize("arch,shape", [("qwen2_0_5b", "train_4k"),
                                        ("olmoe_1b_7b", "decode_32k"),
                                        ("whisper_tiny", "prefill_32k")])
def test_roofline_terms_match(arch, shape, i):
    kind, seq, gb = jconfigs.SHAPES[shape]
    common = dict(trip_counts={}, unresolved_loops=[], **STATS[i])
    js, ts = JStats(**common), TStats(**common)
    j = JR.roofline_terms(arch, shape, "single", 256, js,
                          jconfigs.get(arch), kind, seq, gb)
    t = TR.roofline_terms(arch, shape, "single", 256, ts,
                          tconfigs.get(arch), kind, seq, gb)
    for term, jrate, trate in (
            ("compute_s", JMESH.HW.PEAK_BF16_FLOPS, HW.PEAK_BF16_FLOPS),
            ("memory_s", JMESH.HW.HBM_BW, HW.HBM_BW),
            ("collective_s", JMESH.HW.ICI_BW, HW.ICI_BW)):
        want = getattr(j, term) * jrate
        assert abs(getattr(t, term) * trate - want) <= 1e-12 * max(
            abs(want), 1e-300), term
    terms = {"compute": t.compute_s, "memory": t.memory_s,
             "collective": t.collective_s}
    assert t.dominant == max(terms, key=terms.get)
    jr, tr = j.row(), t.row()
    assert set(tr) == set(jr)
    for k in ("arch", "shape", "mesh", "chips", "model_flops",
              "hlo_flops_per_dev", "useful_ratio", "collective_breakdown",
              "hbm_bytes_per_dev", "note"):
        assert tr[k] == jr[k], k


def _record(arch, shape, mesh, ok=True, tag="", frac=0.5):
    kind, seq, gb = jconfigs.SHAPES[shape]
    rec = {"arch": arch, "shape": shape, "mesh": mesh, "chips": 256,
           "kind": kind, "seq": seq, "batch": gb, "fsdp": True, "tag": tag,
           "ok": ok}
    if ok:
        rec["roofline"] = {"compute_s": frac * 2.0, "memory_s": 2.0,
                           "collective_s": 0.5 + frac,
                           "dominant": "memory", "useful_ratio": frac,
                           "note": ""}
    return rec


def test_roofline_table_and_rows_match(tmp_path, monkeypatch):
    """Records of every kind the table reads: ok and failed, single and
    multi, tagged, cells with no record, a zero-term record; both tables
    and both row lists, read from the same directory."""
    recs = []
    for n, cell in enumerate(CELLS[:14]):
        if cell["skip"]:
            continue
        recs.append(_record(jconfigs.canon(cell["arch"]), cell["shape"],
                            "single", ok=n % 5 != 3, frac=n / 16))
        recs.append(_record(jconfigs.canon(cell["arch"]), cell["shape"],
                            "multi", frac=n / 32))
    recs.append(_record("qwen2_0_5b", "train_4k", "single", tag="nofsdp"))
    zero = _record("mamba2_370m", "decode_32k", "single")
    zero["roofline"].update(compute_s=0.0, memory_s=0.0, collective_s=0.0)
    recs.append(zero)
    out = tmp_path / "experiments" / "dryrun"
    out.mkdir(parents=True)
    for i, r in enumerate(recs):
        (out / f"r{i:03d}.json").write_text(json.dumps(r))
    for mesh in ("single", "multi"):
        assert TTAB.markdown_table(str(out), mesh=mesh) == \
            JTAB.markdown_table(str(out), mesh=mesh)
    monkeypatch.chdir(tmp_path)      # rows() reads the default directory
    assert TTAB.rows() == JTAB.rows()
    assert TTAB.rows()[-1] == ("dryrun_cells_ok", 0.0,
                               float(sum(r["ok"] for r in recs)))


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "deepseek_v3_671b"])
@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_moe_runs_on_fake_tensors(arch, kind):
    stats = port_stats(arch, kind)
    assert stats.dot_flops > 0 and stats.hbm_bytes > 0
