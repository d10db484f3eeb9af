"""Multi-pod dry-run: run every (arch x shape) cell's step once on the
production meshes, on fake tensors, and count one device's work (the port
of ``repro.launch.dryrun``).

Run it as its own process: each cell starts a fake world of 256 (or 512)
ranks in this process (``launch.mesh.fake_world``), which must hold no
other process group.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmoe-1b-7b \\
        --shape train_4k --mesh single --out experiments/dryrun

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
        --device cpu

The parameters, optimizer state, batch and cache are fake tensors of this
rank's blocks, placed as ``DTensor``s by the port's rules
(``launch.sharding``), so nothing is allocated and nothing communicates.
The step (the train step with AdamW, ``forward_prefill``, or the serve
step on a full cache) runs once on them under the counter of
``repro_torch.utils.hlo_analysis``; DTensor lowers each operation to this
rank's local ones and the collectives they need.  Outputs one JSON per
cell with the reference's keys:

  * ``lower_s``: the time to build the placed abstract program;
    ``compile_s``: the time of the counted run;
  * ``memory_analysis``: argument, output and peak temporary bytes per
    device (no generated code);
  * ``cost_analysis``: the FLOPs counted and the bytes accessed;
  * ``hlo``: collective bytes by kind, dot FLOPs, HBM bytes, the
    collective count (no loops to resolve: ``trip_counts`` is empty);
  * the three roofline terms at the H100's rates + the dominant one.

``--device`` sets the device type of the mesh and of the fake tensors
(``cuda`` unless the caller asks for ``cpu``).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch import configs
from repro_torch.compat import DTensor, Shard
from repro_torch.core import prng
from repro_torch.launch import roofline as rl
from repro_torch.launch import sharding as sh
from repro_torch.launch.mesh import (fake_world, make_production_mesh,
                                     production_shape)
from repro_torch.meshctx import spec_placements, use_mesh_rules
from repro_torch.models import transformer as T
from repro_torch.models.common import tree_map
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import make_serve_step, make_train_step
from repro_torch.utils.hlo_analysis import analyze

__all__ = ["build_lowerable", "run_cell", "main"]

# deepseek-671b: bf16 optimizer state, as the reference keeps it.
_OPT_STATE_DTYPE = {"deepseek-v3-671b": torch.bfloat16}


def _local_shape(shape, mesh, placements) -> list:
    """This rank's block of a tensor of ``shape`` under ``placements``: a
    dimension split over a mesh dimension falls into ``torch.chunk``'s
    blocks (the last ones shorter, or empty), mesh dimensions in order."""
    out = list(shape)
    coord = mesh.get_coordinate()
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            n, c, full = mesh.size(i), coord[i], out[p.dim]
            step = -(-full // n)
            out[p.dim] = max(0, min(full, (c + 1) * step) - c * step)
    return out


class Compiled:
    """The counted run of a placed program: the counts, and the reference's
    ``memory_analysis`` / ``cost_analysis`` readings of them."""

    def __init__(self, stats):
        self.stats = stats

    def memory_analysis(self) -> dict:
        s = self.stats
        return {"argument_size_in_bytes": s.argument_bytes,
                "output_size_in_bytes": s.output_bytes,
                "temp_size_in_bytes": s.temp_bytes}

    def cost_analysis(self) -> dict:
        return {"flops": self.stats.dot_flops,
                "bytes accessed": self.stats.hbm_bytes}


@contextlib.contextmanager
def _dryrun_strategies():
    """Some of DTensor's sharding strategies, replaced for the counted run
    (in its private registry) and restored after it.  The collectives any
    of them brings in are counted.

    * ``view`` and ``_unsafe_view`` take ``reshape``'s rule, which
      redistributes the input first.  DTensor refuses a view that would
      split a dimension sharded in a way the split cannot keep: its
      sharding propagation may shard the flat (heads x head_dim) output of
      an ``einsum``'s product over 'model', where the heads do not divide
      it (qwen2-0.5b's 14 on 16), and the einsum's own view back to
      (heads, head_dim) then raises.  XLA reshards there.
    * ``index_put`` (the embedding gather's backward) runs replicated, and
      so does ``flip`` (the cumulative sum's backward) where DTensor has no
      strategy for it (torch 2.11): torch 2.11 builds a negative shard
      dimension for ``index_put`` when the values have more dimensions
      than the destination.
    """
    from torch.distributed.tensor._op_schema import RuntimeSchemaInfo
    from torch.distributed.tensor._ops._view_ops import \
        register_op_strategy_map
    from torch.distributed.tensor._ops.utils import replicate_op_strategy

    aten = torch.ops.aten
    prop = DTensor._op_dispatcher.sharding_propagator
    single = getattr(prop, "op_single_dim_strategy_funcs", {})
    views = (aten.view.default, aten._unsafe_view.default)
    replicated = [aten.index_put.default]
    if aten.flip.default not in prop.op_strategy_funcs and \
            aten.flip.default not in single:
        replicated.append(aten.flip.default)
    saved = [(reg, op, reg.get(op)) for op in (*views, *replicated)
             for reg in (prop.op_strategy_funcs, prop.op_to_schema_info,
                         single)]
    for op in views:
        register_op_strategy_map(op, torch.Tensor.view,
                                 schema_info=RuntimeSchemaInfo(1),
                                 strict_view=False)
    for op in replicated:
        single.pop(op, None)
        prop.op_strategy_funcs[op] = replicate_op_strategy
        prop.op_to_schema_info[op] = RuntimeSchemaInfo(
            1, needs_pytree=op is aten.index_put.default)
    prop.propagate_op_sharding.cache_clear()
    try:
        yield
    finally:
        for reg, op, value in saved:
            if value is None:
                reg.pop(op, None)
            else:
                reg[op] = value
        prop.propagate_op_sharding.cache_clear()


class Lowered:
    """A step and its placed fake inputs on a mesh; ``compile()`` runs the
    step once under the counter, with the mesh and rules active, plain
    tensors the step makes (tables, masks) taken as replicated, and two of
    DTensor's strategies replaced (``_dryrun_strategies``)."""

    def __init__(self, fn, args, mesh, rules):
        self.fn, self.args, self.mesh, self.rules = fn, args, mesh, rules

    def compile(self) -> Compiled:
        with implicit_replication(), _dryrun_strategies(), \
                use_mesh_rules(self.mesh, self.rules):
            _, stats = analyze(self.fn, *self.args)
        return Compiled(stats)


def _placer(mesh):
    """meta tensor, Sharding -> a fake DTensor holding this rank's block,
    built without communication."""
    mode = FakeTensorMode(allow_non_fake_inputs=True)

    def place(meta, sharding):
        with mode:
            local = torch.empty(
                _local_shape(meta.shape, mesh, sharding.placements),
                dtype=meta.dtype, device=mesh.device_type)
        return DTensor.from_local(local, mesh, list(sharding.placements),
                                  run_check=False, shape=meta.shape,
                                  stride=meta.stride())

    return place


def _meta_like(tree, dtype):
    return tree_map(lambda p: torch.empty(p.shape, dtype=dtype,
                                          device="meta"), tree)


def build_lowerable(arch: str, shape_name: str, mesh, *, fsdp: bool = True,
                    rule_overrides=None, cfg_overrides=None):
    """Returns (lower_fn, kind, cfg): lower_fn() -> ``Lowered``."""
    cfg = configs.get(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    kind, seq, gb = configs.SHAPES[shape_name]
    rules = sh.make_rules(cfg, mesh, fsdp=fsdp, global_batch=gb,
                          overrides=rule_overrides)
    aparams, axes = T.abstract_params(cfg)
    param_sh = sh.param_shardings(mesh, axes, rules)
    rep = sh.Sharding(mesh, (), tuple(spec_placements(mesh, ())))

    if kind == "train":
        opt_cfg = AdamWConfig(
            state_dtype=_OPT_STATE_DTYPE.get(cfg.name, torch.float32))
        batch = T.input_specs(cfg, kind, seq, gb)
        batch_sh = sh.batch_shardings(mesh, batch, rules)
        step = make_train_step(cfg, opt_cfg)

        def lower():
            place = _placer(mesh)
            ps = tree_map(place, aparams, param_sh)
            opt = {"m": tree_map(place, _meta_like(aparams,
                                                   opt_cfg.state_dtype),
                                 param_sh),
                   "v": tree_map(place, _meta_like(aparams,
                                                   opt_cfg.state_dtype),
                                 param_sh),
                   "step": place(torch.empty((), dtype=torch.int32,
                                             device="meta"), rep)}
            return Lowered(step, (ps, opt, tree_map(place, batch, batch_sh)),
                           mesh, rules)

        return lower, kind, cfg

    if kind == "prefill":
        batch = T.input_specs(cfg, kind, seq, gb)
        batch_sh = sh.batch_shardings(mesh, batch, rules)

        def fwd(params, batch):
            return T.forward_prefill(params, batch, cfg)

        def lower():
            place = _placer(mesh)
            return Lowered(fwd, (tree_map(place, aparams, param_sh),
                                 tree_map(place, batch, batch_sh)),
                           mesh, rules)

        return lower, kind, cfg

    # decode: one token on a cache of ``seq`` positions, the last written
    specs = T.input_specs(cfg, "decode", seq, gb)
    cache_sh = sh.cache_shardings(mesh, specs["cache"], rules, cfg)
    tok_sh = sh.batch_shardings(mesh, specs["tokens"], rules)
    serve = make_serve_step(cfg)

    def lower():
        place = _placer(mesh)
        key = place(prng.prng_key(0, device="meta"), rep)
        return Lowered(serve, (tree_map(place, aparams, param_sh),
                               place(specs["tokens"], tok_sh),
                               tree_map(place, specs["cache"], cache_sh),
                               seq - 1, key), mesh, rules)

    return lower, kind, cfg


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: str,
             *, fsdp: bool = True, rule_overrides=None, cfg_overrides=None,
             tag: str = "", device="cuda", mesh=None) -> dict:
    """One cell on the production mesh of ``mesh_kind`` (``single`` or
    ``multi``), in a fake world of its size that this call starts and
    ends; or on ``mesh``, a mesh of a world the caller holds (tests: a
    small fake world).  Returns the record, written to ``out_dir``."""
    if mesh is None:
        multi = mesh_kind == "multi"
        shape, _ = production_shape(multi_pod=multi)
        with fake_world(math.prod(shape)):
            return run_cell(
                arch, shape_name, mesh_kind, out_dir, fsdp=fsdp,
                rule_overrides=rule_overrides, cfg_overrides=cfg_overrides,
                tag=tag, device=device,
                mesh=make_production_mesh(multi_pod=multi, device=device))
    kind, seq, gb = configs.SHAPES[shape_name]
    rec: dict = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "chips": mesh.size(), "kind": kind, "seq": seq, "batch": gb,
        "fsdp": fsdp, "tag": tag,
    }
    t0 = time.perf_counter()
    try:
        lower_fn, kind, cfg = build_lowerable(
            arch, shape_name, mesh, fsdp=fsdp,
            rule_overrides=rule_overrides, cfg_overrides=cfg_overrides,
        )
        lowered = lower_fn()
        rec["lower_s"] = time.perf_counter() - t0
        t1 = time.perf_counter()
        compiled = lowered.compile()
        rec["compile_s"] = time.perf_counter() - t1
        rec["memory_analysis"] = compiled.memory_analysis()
        rec["cost_analysis"] = compiled.cost_analysis()
        stats = compiled.stats
        rec["hlo"] = {
            "collective_bytes": stats.collective_bytes,
            "dot_flops": stats.dot_flops,
            "hbm_bytes": stats.hbm_bytes,
            "n_collectives": stats.n_collectives,
            "trip_counts": {k: v for k, v in sorted(
                stats.trip_counts.items())[:20]},
            "unresolved_loops": stats.unresolved_loops[:10],
        }
        report = rl.roofline_terms(
            arch, shape_name, mesh_kind, mesh.size(), stats, cfg, kind, seq,
            gb)
        rec["roofline"] = report.row()
        rec["ok"] = True
    except Exception as e:
        rec["ok"] = False
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    rec["total_s"] = time.perf_counter() - t0

    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        suffix = f"_{tag}" if tag else ""
        path = os.path.join(
            out_dir,
            f"{configs.canon(arch)}__{shape_name}__{mesh_kind}{suffix}.json")
        with open(path, "w") as f:
            json.dump(rec, f, indent=1, default=str)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        cells = configs.cells()
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells = [{"arch": args.arch, "shape": args.shape}]

    results = []
    for cell in cells:
        for mk in meshes:
            rec = run_cell(cell["arch"], cell["shape"], mk, args.out,
                           fsdp=not args.no_fsdp, device=args.device)
            status = "OK " if rec["ok"] else "FAIL"
            print(f"[{status}] {cell['arch']:>20s} {cell['shape']:>12s} "
                  f"{mk:>6s}  lower={rec.get('lower_s', 0):6.1f}s "
                  f"compile={rec.get('compile_s', 0):6.1f}s "
                  f"{rec.get('error', '')}", flush=True)
            results.append(rec)
    n_ok = sum(r["ok"] for r in results)
    print(f"\n{n_ok}/{len(results)} cells passed")
    return 0 if n_ok == len(results) else 1


if __name__ == "__main__":
    raise SystemExit(main())
