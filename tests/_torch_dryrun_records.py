"""Shared by ``tests/test_torch_dryrun_{world,cells}.py``: runs one part of
``tests/_torch_dryrun_worker.py`` (the fake world, in a process of its own)
and holds its ``run_cell`` records to the reference.

A record of a smoke family's decode cell on the fake 2x2 world must be ok,
carry the reference's keys, hold per-device argument bytes equal to the sum
of each leaf's local block under the reference's ``make_rules`` /
``logical_to_spec`` (rank 0's block: ``ceil`` of each split, mesh axes in
order; computed here, uneven splits included), and the reference's
``model_flops``.
"""
import dataclasses
import json
import os
import subprocess
import sys
import types

import jax
import numpy as np

from repro import configs as jconfigs
from repro.launch import roofline as JR
from repro.launch import sharding as JSH
from repro.meshctx import logical_to_spec
from repro.models import transformer as JT

HERE = os.path.dirname(__file__)
sys.path.insert(0, HERE)
import _torch_dryrun_worker as W  # noqa: E402

# The keys of an ok record of the reference's ``run_cell``
# (``src/repro/launch/dryrun.py:126``).
RECORD_KEYS = {"arch", "shape", "mesh", "chips", "kind", "seq", "batch",
               "fsdp", "tag", "lower_s", "compile_s", "memory_analysis",
               "cost_analysis", "hlo", "roofline", "ok", "total_s"}
HLO_KEYS = {"collective_bytes", "dot_flops", "hbm_bytes", "n_collectives",
            "trip_counts", "unresolved_loops"}
# the reference's memory_analysis also reads generated_code_size_in_bytes,
# and its cost_analysis optimal_seconds: torch has neither
MEMORY_KEYS = {"argument_size_in_bytes", "output_size_in_bytes",
               "temp_size_in_bytes"}
COST_KEYS = {"flops", "bytes accessed"}
KEY_BYTES = 2 * 8       # the port's threefry key: two int64 words


def run_worker(path, part: int) -> dict:
    """Part ``part`` of the worker, run in ``path``; its result, with the
    records' directory under ``dir``."""
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "..", "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, os.path.join(HERE, "_torch_dryrun_worker.py"),
         str(path), str(part)], env=env, capture_output=True, text=True,
        timeout=240)
    assert out.returncode == 0, (out.stdout + out.stderr)[-4000:]
    res = json.loads((path / f"result{part}.json").read_text())
    res["dir"] = path / "dryrun"
    return res


def _block_bytes(shape, spec, sizes, itemsize) -> int:
    n = 1
    for d, full in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        axes = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        for a in axes:
            full = -(-full // sizes[a])
        n *= full
    return n * itemsize


def _cache_spec(path, leaf, rules, cfg):
    """The reference's ``cache_shardings`` spec of one cache leaf."""
    batch = rules.get("batch")
    nd = len(leaf.shape)
    if "enc_out" in path:
        return (batch,) + (None,) * (nd - 1)
    if nd >= 4 and cfg.n_kv and leaf.shape[-2] == cfg.n_kv:
        return (None, batch) + (None,) * (nd - 4) + (rules.get("kv_heads"),
                                                      None)
    return (None, batch) + (None,) * (nd - 2) if nd >= 2 else ()


def reference_argument_bytes(arch, extra) -> int:
    """Rank 0's argument bytes of the decode cell: parameters, tokens and
    cache under the reference's rules, and the port's key (the reference's
    key is a uint32 pair and its ``pos`` an int32 scalar; the port passes
    ``pos`` as an int)."""
    cfg = dataclasses.replace(jconfigs.get_smoke(arch), **extra)
    kind, seq, gb = W.SMALL["decode_32k"]
    sizes = {"data": 2, "model": 2}
    rules = JSH.make_rules(cfg, types.SimpleNamespace(
        axis_names=("data", "model"), shape=sizes), fsdp=True,
        global_batch=gb)
    ap, axes = JT.abstract_params(cfg)
    total = 0
    for leaf, ax in zip(jax.tree.leaves(ap), jax.tree.leaves(
            axes, is_leaf=lambda x: isinstance(x, tuple))):
        total += _block_bytes(leaf.shape, logical_to_spec(ax, rules), sizes,
                              np.dtype(leaf.dtype).itemsize)
    specs = JT.input_specs(cfg, kind, seq, gb)
    tok = specs["tokens"]
    total += _block_bytes(tok.shape, (rules["batch"], None), sizes,
                          np.dtype(tok.dtype).itemsize)
    for path, leaf in jax.tree_util.tree_flatten_with_path(specs["cache"])[0]:
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        total += _block_bytes(leaf.shape, _cache_spec(name, leaf, rules, cfg),
                              sizes, np.dtype(leaf.dtype).itemsize)
    return total + KEY_BYTES


def check_record(result, i) -> None:
    arch, extra, tag = W.CELLS[i]
    rec = next(r for r in result["cells"]
               if r["arch"] == arch and r["tag"] == tag)
    assert rec["ok"], rec.get("traceback")
    assert set(rec) == RECORD_KEYS
    assert set(rec["hlo"]) == HLO_KEYS
    assert set(rec["memory_analysis"]) == MEMORY_KEYS
    assert set(rec["cost_analysis"]) == COST_KEYS
    assert set(rec["roofline"]) == {
        f.name for f in dataclasses.fields(JR.RooflineReport)}
    assert rec["chips"] == 4 and rec["mesh"] == "single"
    suffix = f"_{tag}" if tag else ""
    on_disk = json.loads((result["dir"] / f"{arch}__decode_32k__single"
                          f"{suffix}.json").read_text())
    assert on_disk["ok"] and on_disk["hlo"] == rec["hlo"]
    assert rec["memory_analysis"]["argument_size_in_bytes"] == \
        reference_argument_bytes(arch, extra)
    cfg = dataclasses.replace(jconfigs.get_smoke(arch), **extra)
    kind, seq, gb = W.SMALL["decode_32k"]
    assert rec["roofline"]["model_flops"] == JR.model_flops(cfg, kind, seq,
                                                            gb)
    assert rec["hlo"]["dot_flops"] > 0
    assert rec["hlo"]["trip_counts"] == {}


def cell_ids(part: int) -> list:
    return [(i, f"{a}{'-' + t if t else ''}")
            for i, (a, _, t) in enumerate(W.CELLS) if W.part_of(i) == part]
