"""The fake-world half of ``tests/test_torch_dryrun_world.py`` (jax-free),
run in a process of its own so that no other test's process group meets
the fake world and the fake world outlives nothing.

    python tests/_torch_dryrun_worker.py OUT_DIR PART

Part 0 writes ``OUT_DIR/result0.json`` with ``meshes``, ``loop``,
``kinds`` and the first half of ``cells``; part 1 ``OUT_DIR/result1.json``
with the rest of ``cells`` (two processes share the work):

* ``meshes``: shape, names and size of ``make_production_mesh`` (single
  and multi pod) inside ``fake_world(256 / 512)``, what raised inside it
  (a second ``fake_world``, ``make_local_mesh``), and whether a default
  group is up after each world ended and before any began;
* ``loop`` and ``kinds``: ``analyze`` of the reference's canned programs
  on a fake world of 4 (a 12-iteration loop of an 8x8 all-reduce and a
  product; an all-to-all, a reduce-scatter, a point-to-point receive and
  an all-gather);
* ``cells``: ``run_cell``'s record of each smoke family's decode cell on a
  fake 2x2 world (``SHAPES`` cut to the small sizes of ``SMALL``), plus
  qwen2 with ``d_ff=129`` so that the MLP splits unevenly over 'model';

and the records themselves under ``OUT_DIR/dryrun``.
"""
import dataclasses
import json
import os
import sys

import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol

from repro_torch import configs
from repro_torch.compat import init_device_mesh
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import (fake_world, make_local_mesh,
                                     make_production_mesh)
from repro_torch.utils.hlo_analysis import analyze

SMALL = {"train_4k": ("train", 64, 8), "prefill_32k": ("prefill", 64, 8),
         "decode_32k": ("decode", 64, 8), "long_500k": ("decode", 128, 1)}
UNEVEN = {"d_ff": 129}


def _raises(fn) -> str:
    try:
        fn()
    except RuntimeError as e:
        return str(e)
    return ""


def meshes() -> dict:
    out = {"up_before": dist.is_initialized(),
           "outside": _raises(lambda: make_production_mesh(device="cpu"))}
    for multi, n in ((False, 256), (True, 512)):
        with fake_world(n):
            m = make_production_mesh(multi_pod=multi, device="cpu")
            out[str(n)] = {
                "shape": list(m.shape), "names": list(m.mesh_dim_names),
                "size": m.size(), "world": dist.get_world_size(),
                "backend": dist.get_backend(),
                "nested": _raises(lambda: fake_world(2).__enter__()),
                "local": _raises(lambda: make_local_mesh(device="cpu"))}
        out[f"up_after_{n}"] = dist.is_initialized()
    return out


def _stats(s) -> dict:
    return {"collective_bytes": s.collective_bytes,
            "dot_flops": s.dot_flops, "n_collectives": s.n_collectives,
            "trip_counts": s.trip_counts,
            "unresolved_loops": s.unresolved_loops}


def canned() -> dict:
    def loop(x):
        group = dist.group.WORLD
        for _ in range(12):
            x = funcol.all_reduce(x, "sum", group)
            x = x @ x
        return x

    def kinds(x):
        group = dist.group.WORLD
        a2a = funcol.all_to_all_single(x, None, None, group)
        rs = funcol.reduce_scatter_tensor(a2a, "sum", 0, group)
        dist.send(torch.zeros(4, 8), 1)
        cp = torch.empty(4, 8)
        dist.recv(cp, 1)
        ag = funcol.all_gather_tensor(cp + rs, 0, group)
        return ag + a2a

    with fake_world(4):
        _, s_loop = analyze(loop, torch.ones(8, 8))
        _, s_kinds = analyze(kinds, torch.ones(16, 8))
    return {"loop": _stats(s_loop), "kinds": _stats(s_kinds)}


CELLS = [(a, {}, "") for a in configs.ARCHS] + [
    ("qwen2_0_5b", UNEVEN, "uneven")]


def part_of(i: int) -> int:
    """Which worker part runs cell ``i`` (part 0 also runs the meshes and
    the canned programs)."""
    return int(i >= len(CELLS) // 2)


def cells(out_dir, part) -> list:
    configs.SHAPES.update(SMALL)
    recs = []
    with fake_world(4):
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        for arch, extra, tag in [c for i, c in enumerate(CELLS)
                                 if part_of(i) == part]:
            smoke = dataclasses.replace(configs.get_smoke(arch), **extra)
            over = {f.name: getattr(smoke, f.name)
                    for f in dataclasses.fields(smoke)}
            recs.append(dryrun.run_cell(arch, "decode_32k", "single",
                                        out_dir, cfg_overrides=over,
                                        tag=tag, device="cpu", mesh=mesh))
    return recs


def main(path, part):
    torch.set_num_threads(1)
    result = {"meshes": meshes(), **canned()} if part == 0 else {}
    result["cells"] = cells(os.path.join(path, "dryrun"), part)
    with open(os.path.join(path, f"result{part}.json"), "w") as f:
        json.dump(result, f, default=str)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
