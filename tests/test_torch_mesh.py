"""The port's mesh and sharding layer (``repro_torch.{compat,meshctx}``,
``launch.mesh``, the LM half of ``launch.sharding``) and its all-to-all
MoE (``models.mlp.moe_apply_a2a``), held to the reference.

* Specs and rules: ``logical_to_spec``, ``make_rules`` (fsdp on and off,
  ``global_batch`` 1/2/256, the MQA / heads / vocab / expert fallbacks),
  ``data_axes`` and the specs of ``param_shardings`` / ``batch_shardings``
  / ``cache_shardings`` equal the reference's entry for entry
  (``tuple(PartitionSpec)``), for every leaf of the 10 full configs on a
  1x1 mesh and on 16x16 and 2x16x16 records; no spec names a mesh axis
  twice.  These functions are pure: jax 0.9's mesh fault (ROADMAP F2)
  does not touch them.
* One rank (a world-1 gloo group in this process, torn down with the
  file): ``moe_apply_a2a`` equals the port's ``moe_apply`` exactly, its
  aux within 1e-6 and its gradients within 1e-6 (olmoe smoke, float32,
  x (2,32,d)); it is within ``F32 * max(1, max|ref|)`` of JAX's
  ``moe_apply``.  A qwen2 and an olmoe (``moe_a2a=True``) smoke train step
  under ``use_mesh_rules`` is bit-equal to the step without a mesh.
* Eight ranks (gloo subprocesses, ``tests/_torch_mesh_worker.py``, a
  (2, 4) mesh, x (4,32,d), ``capacity_factor=8.0`` so no token drops):
  the gathered output equals ``moe_apply`` on the whole batch exactly
  (plain and DTensor inputs; JAX's within ``F32``); aux equals the mean of
  the blocks' ``moe_apply`` aux within 1e-6 (it is a per-shard quantity);
  gradients within ``1e-6 * max|g_ref(leaf)|`` (the ranks' partial sums
  round in another order); every placed olmoe leaf holds the block its
  spec names.
"""
import dataclasses
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from _torch_lm_harness import assert_close, cfg_pair, to_np
from repro import configs as jconfigs
from repro.launch import sharding as JSH
from repro.meshctx import logical_to_spec as j_logical_to_spec
from repro.models import common as JC
from repro.models import mlp as JM
from repro.models import transformer as JT
from repro_torch import compat
from repro_torch import configs as tconfigs
from repro_torch.launch import sharding as TSH
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.meshctx import (current_mesh, logical_to_spec,
                                 shard_act, spec_placements, use_mesh_rules)
from repro_torch.models import mlp as TM
from repro_torch.models import transformer as TT
from repro_torch.models.common import ParamSpec, params_from_numpy
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.train.train_step import make_train_step

HERE = os.path.dirname(__file__)
SRC = os.path.join(HERE, "..", "src")


@pytest.fixture(scope="module")
def mesh1():
    """A 1x1 gloo mesh over a world of one rank in this process."""
    own = not dist.is_initialized()
    mesh = make_local_mesh(data=4, model=2, device="cpu")
    yield mesh
    if own:
        dist.destroy_process_group()


def _record(shape: dict):
    return types.SimpleNamespace(axis_names=tuple(shape), shape=dict(shape))


RECORDS = {
    "16x16": {"data": 16, "model": 16},
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
    "4x3": {"data": 4, "model": 3},          # experts, heads, vocab fall back
}


def _flat(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], (*path, str(k))))
        return out
    return {"/".join(path): tree}


def _axes(spec):
    if isinstance(spec, dict):
        return {k: _axes(v) for k, v in spec.items()}
    assert isinstance(spec, ParamSpec)
    return spec.axes


def _meta(tree):
    """A JAX abstract tree as port meta tensors of the same shapes."""
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}
    return torch.empty(tree.shape, device="meta")


# --- specs and rules --------------------------------------------------------


def test_logical_to_spec_matches_the_reference():
    rules = {"batch": ("pod", "data"), "one": ("data",), "none": (),
             "m": "model", "r": None}
    for axes in [("batch", None, "m"), ("one", "none", "r", "unknown"), (),
                 (None,), ("m", "batch")]:
        assert logical_to_spec(axes, rules) == \
            tuple(j_logical_to_spec(axes, rules)), axes


@pytest.mark.parametrize("mesh", ["1x1", *RECORDS])
@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_rules_match_the_reference(arch, mesh):
    shape = {"data": 1, "model": 1} if mesh == "1x1" else RECORDS[mesh]
    rec = _record(shape)
    jcfg, tcfg = jconfigs.get(arch), tconfigs.get(arch)
    assert TSH.data_axes(rec) == JSH.data_axes(rec)
    for fsdp in (True, False):
        for gb in (None, 1, 2, 256):
            kw = dict(fsdp=fsdp, global_batch=gb)
            assert TSH.make_rules(tcfg, rec, **kw) == \
                JSH.make_rules(jcfg, rec, **kw), kw
    over = {"embed": ("data", "model"), "vocab": None}
    assert TSH.make_rules(tcfg, rec, overrides=over) == \
        JSH.make_rules(jcfg, rec, overrides=over)


def test_rule_fallbacks_are_exercised():
    """The 4x3 record trips every fallback the reference has."""
    rec = _record(RECORDS["4x3"])
    olmoe = TSH.make_rules(tconfigs.get("olmoe-1b-7b"), rec)
    assert olmoe["expert"] is None and olmoe["expert_mlp"] == "model"
    qwen = TSH.make_rules(tconfigs.get("qwen2-0.5b"), _record(RECORDS["16x16"]))
    assert qwen["heads"] is None and qwen["kv_heads"] is None
    whisper = TSH.make_rules(tconfigs.get("whisper-tiny"), rec)
    assert whisper["vocab"] is None
    big = _record(RECORDS["2x16x16"])
    cfg = tconfigs.get("mamba2-370m")
    assert TSH.make_rules(cfg, big, global_batch=1)["batch"] == ()
    assert TSH.make_rules(cfg, big, global_batch=2)["batch"] == ("pod",)
    assert TSH.make_rules(cfg, big, global_batch=256)["batch"] == \
        ("pod", "data")


def _jmesh(names):
    return jax.make_mesh((1,) * len(names), names)


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_shardings_match_the_reference(mesh1, arch):
    """param / batch / cache specs of every leaf of the full config: on the
    1x1 mesh and under the 16x16 and 2x16x16 records' rules."""
    jcfg, tcfg = jconfigs.get(arch), tconfigs.get(arch)
    _, jaxes = JT.abstract_params(jcfg)
    taxes = _axes(TT.init_spec(tcfg))
    jflat = _flat(jaxes)
    assert jflat.keys() == _flat(taxes).keys()

    for name in ("1x1", "16x16", "2x16x16"):
        shape = {"data": 1, "model": 1} if name == "1x1" else RECORDS[name]
        rec = _record(shape)
        jmesh = _jmesh(tuple(shape))
        jrules = JSH.make_rules(jcfg, rec if name != "1x1" else jmesh)
        trules = TSH.make_rules(tcfg, rec if name != "1x1" else mesh1)
        assert trules == jrules
        tmesh = mesh1 if name == "1x1" else rec

        got = _flat(TSH.param_shardings(tmesh, taxes, trules))
        want = _flat(JSH.param_shardings(jmesh, jaxes, jrules))
        for k, w in want.items():
            assert got[k].spec == tuple(w.spec), (name, k)
            flat = [a for e in got[k].spec if e
                    for a in (e if isinstance(e, tuple) else (e,))]
            assert len(flat) == len(set(flat)), (name, k, got[k].spec)

        for kind, seq in (("train", 64), ("prefill", 64), ("decode", 32)):
            jb = JT.input_specs(jcfg, kind, seq, 2)
            got = _flat(TSH.batch_shardings(tmesh, _meta(jb), trules))
            want = _flat(JSH.batch_shardings(jmesh, jb, jrules))
            assert got.keys() == want.keys()
            for k, w in want.items():
                assert got[k].spec == tuple(w.spec), (name, kind, k)

        jc = JT.init_cache(jcfg, 2, 32)
        tc = TT.init_cache(tcfg, 2, 32)
        got = _flat(TSH.cache_shardings(tmesh, tc, trules, tcfg))
        want = _flat(JSH.cache_shardings(jmesh, jc, jrules, jcfg))
        assert got.keys() == want.keys()
        for k, w in want.items():
            assert got[k].spec == tuple(w.spec), (name, k)
        for s in got.values():
            assert len(s.placements) == len(shape)


def test_placements_follow_the_spec():
    rec = _record({"pod": 2, "data": 4, "model": 2})
    S, R = compat.Shard, compat.Replicate
    assert spec_placements(rec, (("pod", "data"), None, "model")) == \
        [S(0), S(0), S(2)]
    assert spec_placements(rec, (None, "data")) == [R(), S(1), R()]
    assert spec_placements(rec, ()) == [R(), R(), R()]
    with pytest.raises(ValueError, match="twice"):
        spec_placements(rec, ("model", "model"))
    with pytest.raises(ValueError, match="twice"):
        spec_placements(rec, (("data", "model"), "data"))
    with pytest.raises(ValueError, match="order"):
        spec_placements(rec, (("data", "pod"),))


# --- one rank ---------------------------------------------------------------


def test_local_mesh_is_clamped_to_the_world(mesh1):
    assert mesh1.mesh_dim_names == ("data", "model")
    assert tuple(mesh1.shape) == (1, 1)
    assert mesh1.device_type == "cpu"


def test_shard_act_never_changes_a_value(mesh1):
    x = torch.arange(24.0).reshape(2, 3, 4)
    assert current_mesh() is None
    assert shard_act(x, "batch", "seq", None) is x
    rules = {"batch": ("data",), "seq": None}
    with use_mesh_rules(mesh1, rules):
        assert current_mesh() is mesh1
        assert shard_act(x, "batch", "seq", None) is x
        d = compat.distribute_tensor(x, mesh1, [compat.Replicate()] * 2)
        y = shard_act(d, "batch", "seq", None)
        assert isinstance(y, compat.DTensor)
        assert list(y.placements) == [compat.Shard(0), compat.Replicate()]
        assert torch.equal(y.full_tensor(), x)
    assert current_mesh() is None


def _olmoe():
    jcfg, tcfg = cfg_pair("olmoe_1b_7b")
    jp, _ = JC.init_dense(jax.random.PRNGKey(0), JM.moe_spec(jcfg),
                          jnp.float32)
    tp = params_from_numpy(to_np(jp), tcfg, "cpu")
    return jcfg, tcfg, jp, tp


def _grads(fn, p, x, cfg, mesh=None, rules=None):
    pp = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    xx = x.clone().requires_grad_(True)
    if mesh is None:
        y, aux = fn(pp, xx, cfg)
    else:
        with use_mesh_rules(mesh, rules):
            y, aux = fn(pp, xx, cfg)
    (y.square().sum() + aux).backward()
    return {**{k: v.grad for k, v in pp.items()}, "x": xx.grad}


def test_a2a_equals_moe_apply_on_one_rank(mesh1):
    jcfg, tcfg, jp, tp = _olmoe()
    xn = np.random.default_rng(1).normal(0, 1, (2, 32, tcfg.d_model))
    xn = xn.astype(np.float32)
    x = torch.from_numpy(xn)
    rules = TSH.make_rules(tcfg, mesh1)
    y1, a1 = TM.moe_apply(tp, x, tcfg)
    with use_mesh_rules(mesh1, rules):
        y2, a2 = TM.moe_apply_a2a(tp, x, tcfg)
    assert torch.equal(y1, y2)
    assert abs(float(a1) - float(a2)) < 1e-6
    yj, aj = JM.moe_apply(jp, jnp.asarray(xn), jcfg)
    assert_close(y2, yj, what="a2a vs JAX moe_apply")
    assert abs(float(a2) - float(aj)) < 1e-6

    xg = torch.from_numpy(np.random.default_rng(2).normal(
        0, 1, (2, 16, tcfg.d_model)).astype(np.float32))
    g1 = _grads(TM.moe_apply, tp, xg, tcfg)
    g2 = _grads(TM.moe_apply_a2a, tp, xg, tcfg, mesh1, rules)
    for k in g1:
        assert float((g1[k] - g2[k]).abs().max()) <= 1e-6, k


def test_a2a_falls_back_where_the_reference_does():
    """No mesh, experts not divisible by 'model', tokens not divisible by
    (batch shards x model), or a sequence not divisible by 'model': the
    plain ``moe_apply`` (checked before the mesh is asked anything)."""
    _, tcfg, _, tp = _olmoe()
    x = torch.from_numpy(np.random.default_rng(3).normal(
        0, 1, (2, 30, tcfg.d_model)).astype(np.float32))
    want, aux = TM.moe_apply(tp, x, tcfg)
    got, got_aux = TM.moe_apply_a2a(tp, x, tcfg)
    assert torch.equal(got, want) and torch.equal(got_aux, aux)
    for shape in ({"data": 1, "model": 3},      # e % m
                  {"data": 8, "model": 1},      # t % (dp m)
                  {"data": 1, "model": 4}):     # s % m
        rec = _record(shape)
        with use_mesh_rules(rec, TSH.make_rules(tcfg, rec)):
            got, got_aux = TM.moe_apply_a2a(tp, x, tcfg)
        assert torch.equal(got, want) and torch.equal(got_aux, aux), shape


@pytest.mark.parametrize("arch,a2a", [("qwen2_0_5b", False),
                                      ("olmoe_1b_7b", True)])
def test_train_step_under_the_mesh_is_bit_equal(mesh1, arch, a2a):
    cfg = dataclasses.replace(tconfigs.get_smoke(arch),
                              param_dtype=torch.float32,
                              act_dtype=torch.float32, moe_a2a=a2a)
    params, _ = TT.init_params(cfg, torch.Generator().manual_seed(0))
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (2, 32))).int()
             for k in ("tokens", "labels")}
    batch["mask"] = torch.ones(2, 32)
    step = make_train_step(cfg, opt_cfg)

    def run(mesh):
        opt = adamw_init(params, opt_cfg)
        if mesh is None:
            return step(params, opt, batch)
        with use_mesh_rules(mesh, TSH.make_rules(cfg, mesh, global_batch=2)):
            return step(params, opt, batch)

    p0, _, m0 = run(None)
    p1, _, m1 = run(mesh1)
    assert torch.equal(m0["loss"], m1["loss"])
    f0, f1 = _flat(p0), _flat(p1)
    for k in f0:
        assert torch.equal(f0[k], f1[k]), k


# --- eight ranks --------------------------------------------------------------


def test_a2a_exact_on_8_gloo_ranks(tmp_path):
    jcfg, tcfg, jp, tp = _olmoe()
    xn = np.random.default_rng(1).normal(0, 1, (4, 32, tcfg.d_model))
    xn = xn.astype(np.float32)
    np.savez(tmp_path / "in.npz", x=xn,
             **{k: v.numpy() for k, v in tp.items()})
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    worker = os.path.join(HERE, "_torch_mesh_worker.py")
    procs = [subprocess.Popen(
        [sys.executable, worker, str(r), "8", "2", "4", str(tmp_path)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(8)]
    try:
        outs = [p.communicate(timeout=180)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(outs)[-4000:]
    o = np.load(tmp_path / "out.npz")

    x = torch.from_numpy(xn)
    want, _ = TM.moe_apply(tp, x, tcfg, capacity_factor=8.0)
    np.testing.assert_array_equal(o["y"], want.numpy())
    np.testing.assert_array_equal(o["y_dtensor"], want.numpy())
    yj, _ = JM.moe_apply(jp, jnp.asarray(xn), jcfg, capacity_factor=8.0)
    assert_close(torch.from_numpy(o["y"]), yj, what="8 ranks vs JAX")

    # aux is per shard: the mean over the (data, model) blocks
    def blocks_aux(pp, xx):
        auxes = [TM.moe_apply(pp, xx[i * 2:(i + 1) * 2, j * 8:(j + 1) * 8],
                              tcfg, capacity_factor=8.0)[1]
                 for i in range(2) for j in range(4)]
        return torch.stack(auxes).mean()

    aux = blocks_aux(tp, x)
    assert abs(float(o["aux"]) - float(aux)) < 1e-6
    assert abs(float(o["aux_dtensor"]) - float(aux)) < 1e-6

    pp = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    xx = x.clone().requires_grad_(True)
    y, _ = TM.moe_apply(pp, xx, tcfg, capacity_factor=8.0)
    (y.square().sum() + blocks_aux(pp, xx)).backward()
    for k, g in {**{k: v.grad for k, v in pp.items()}, "x": xx.grad}.items():
        err = float(np.abs(o[f"g_{k}"] - g.numpy()).max())
        assert err <= 1e-6 * float(g.abs().max()), (k, err)
    assert int(o["n_checked"]) == len(_flat(TT.init_spec(tcfg))) + 1
    assert str(o["split2_spec"]) == "(None, ('data', 'model'))"
