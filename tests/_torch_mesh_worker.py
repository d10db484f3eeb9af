"""One rank of the gloo mesh test in ``tests/test_torch_mesh.py`` (jax-free).

    python tests/_torch_mesh_worker.py RANK WORLD DATA MODEL DIR

Joins a gloo group of WORLD ranks through the file store ``DIR/store``,
builds the (DATA, MODEL) mesh with ``make_local_mesh`` and, on the olmoe
smoke config in float32 with the weights and input of ``DIR/in.npz``:

* runs ``moe_apply_a2a`` at ``capacity_factor=8.0`` on the plain input
  (values, aux, and the gradients of ``sum(y**2) + aux``) and on the
  input and weights placed as DTensors by ``batch_shardings`` /
  ``param_shardings`` (fsdp rules);
* checks every rank's local block of each placed olmoe leaf (and of the
  embedding split over ``("data", "model")``) against the slice of the
  full array that its spec names, JAX's major-to-minor order.

Rank 0 writes ``DIR/out.npz``; every rank writes ``DIR/rank<r>.ok``.
"""
import dataclasses
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.compat import DTensor
from repro_torch.launch import sharding as sh
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.meshctx import use_mesh_rules
from repro_torch.models import mlp as TM
from repro_torch.models import transformer as TT


def spec_block(full: np.ndarray, spec, mesh) -> np.ndarray:
    """The block of ``full`` that this rank holds under ``spec``: a tensor
    dimension split over mesh axes (a1, a2, ...) takes block index
    ``(c_a1 * n_a2 + c_a2) ...``, the first axis the major one."""
    out = full
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx, n = 0, 1
        for a in axes:
            size = mesh.size(mesh.mesh_dim_names.index(a))
            idx = idx * size + mesh.get_local_rank(a)
            n *= size
        step = full.shape[d] // n
        out = np.take(out, range(idx * step, (idx + 1) * step), axis=d)
    return out


def main(rank, world, data, model, path):
    dist.init_process_group("gloo", init_method=f"file://{path}/store",
                            rank=rank, world_size=world)
    torch.set_num_threads(1)
    mesh = make_local_mesh(data=data, model=model, device="cpu")
    cfg = dataclasses.replace(configs.get_smoke("olmoe_1b_7b"),
                              param_dtype=torch.float32,
                              act_dtype=torch.float32)
    src = np.load(f"{path}/in.npz")
    p = {k: torch.from_numpy(src[k]) for k in ("router", "wg", "wu", "wd")}
    x = torch.from_numpy(src["x"])
    rules = sh.make_rules(cfg, mesh)
    out = {}

    # plain tensors: the whole output and the replicated gradients
    pp = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    xx = x.clone().requires_grad_(True)
    with use_mesh_rules(mesh, rules):
        y, aux = TM.moe_apply_a2a(pp, xx, cfg, capacity_factor=8.0)
    (y.square().sum() + aux).backward()
    out["y"], out["aux"] = y.detach().numpy(), aux.detach().numpy()
    out["g_x"] = xx.grad.numpy()
    for k, v in pp.items():
        out[f"g_{k}"] = v.grad.numpy()

    # the same through DTensors placed by the fsdp rules
    axes = TM.moe_spec(cfg)
    psh = sh.param_shardings(mesh, {k: axes[k].axes for k in p}, rules)
    pd = {k: psh[k].place(v) for k, v in p.items()}
    xd = sh.batch_shardings(mesh, {"x": x}, rules)["x"].place(x)
    with use_mesh_rules(mesh, rules):
        yd, auxd = TM.moe_apply_a2a(pd, xd, cfg, capacity_factor=8.0)
    assert isinstance(yd, DTensor) and isinstance(auxd, DTensor)
    out["y_dtensor"] = yd.full_tensor().numpy()
    out["aux_dtensor"] = auxd.full_tensor().numpy()

    # every placed leaf of the olmoe smoke model holds its spec's block
    spec = TT.init_spec(cfg)
    leaves, checked = [], 0

    def walk(t, path=()):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], (*path, k))
        else:
            leaves.append(("/".join(path), t))

    walk(spec)
    gen = torch.Generator().manual_seed(0)
    split2 = dict(rules, vocab=None, embed=("data", "model"))
    cases = [(n, s.shape, s.axes, rules) for n, s in leaves]
    cases.append(("embed over (data, model)", spec["embed"].shape,
                  spec["embed"].axes, split2))
    for name, shape, ax, r in cases:
        full = torch.randn(shape, generator=gen)
        s = sh.param_shardings(mesh, {"a": ax}, r)["a"]
        local = s.place(full).to_local().numpy()
        np.testing.assert_array_equal(
            local, spec_block(full.numpy(), s.spec, mesh), err_msg=name)
        checked += 1
    out["n_checked"] = np.int64(checked)
    out["split2_spec"] = np.array(repr(sh.param_shardings(
        mesh, {"a": spec["embed"].axes}, split2)["a"].spec))

    # every rank holds the same whole output and gradients
    for k in ("y", "g_x", "g_router", "g_wg"):
        t = torch.from_numpy(out[k])
        ref = t.clone()
        dist.broadcast(ref, 0)
        assert torch.equal(t, ref), k

    if rank == 0:
        np.savez(f"{path}/out.npz", **out)
    dist.barrier()
    dist.destroy_process_group()
    open(f"{path}/rank{rank}.ok", "w").write("ok")


if __name__ == "__main__":
    r, w, d, m = (int(a) for a in sys.argv[1:5])
    main(r, w, d, m, sys.argv[5])
