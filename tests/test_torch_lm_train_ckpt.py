"""Checkpoints and the train supervisor in the port
(``repro_torch.train.checkpoint``, ``repro_torch.train.fault_tolerance``)
against the reference's: the same tree gives the same manifest and the
same stored arrays (bfloat16 as raw 2-byte values), and each package
restores the other's checkpoint value for value; then the reference's own
cases of ``tests/test_train_infra.py`` and
``tests/test_drivers.py::test_restore_across_mesh_change`` reproduced on
the port, and the port's own duties (the async snapshot copies, a retried
step restarts from the same state, restored leaves go back onto their
device and dtype).  Bound: every value exactly equal.
"""
import json
import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import checkpoint as jck
from repro_torch.train import checkpoint as tck
from repro_torch.train.fault_tolerance import (StragglerMonitor,
                                               TrainSupervisor,
                                               elastic_remesh)


def _trees():
    """The same (params, opt_state) tree for both packages: float32,
    bfloat16 and int32 leaves, nested dicts in a tuple."""
    rng = np.random.default_rng(0)
    w = rng.normal(0, 1, (3, 5, 7)).astype(np.float32)
    e = rng.normal(0, 1, (11, 4)).astype(np.float32)
    m = rng.normal(0, 1, (3, 5, 7)).astype(np.float32)
    jt = ({"blocks": {"w": jnp.asarray(w)}, "embed": jnp.asarray(e, jnp.bfloat16)},
          {"m": {"blocks": {"w": jnp.asarray(m)}}, "step": jnp.int32(7)})
    tt = ({"blocks": {"w": torch.from_numpy(w)},
           "embed": torch.from_numpy(e).to(torch.bfloat16)},
          {"m": {"blocks": {"w": torch.from_numpy(m)}},
           "step": torch.tensor(7, dtype=torch.int32)})
    return jt, tt


def _bits(x):
    """A leaf's stored bits: bfloat16 as uint16, the rest as is."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.uint16).numpy()
        return x.numpy()
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16)
    return a


def _same(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    else:
        g, w = _bits(got), _bits(want)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_the_same_tree_gives_the_same_files(tmp_path):
    jt, tt = _trees()
    jck.save(str(tmp_path / "j"), 3, jt, extra={"data_cursor": 3})
    tck.save(str(tmp_path / "t"), 3, tt, extra={"data_cursor": 3})
    step = "step_000000003"
    mj = json.loads((tmp_path / "j" / step / "manifest.json").read_text())
    mt = json.loads((tmp_path / "t" / step / "manifest.json").read_text())
    assert mt == mj
    assert [leaf["path"] for leaf in mt["leaves"]] == [
        "0/blocks/w", "0/embed", "1/m/blocks/w", "1/step"]
    assert [leaf["dtype"] for leaf in mt["leaves"]] == [
        "float32", "bfloat16", "float32", "int32"]
    with np.load(tmp_path / "j" / step / "shard_0000.npz") as zj, \
            np.load(tmp_path / "t" / step / "shard_0000.npz") as zt:
        assert sorted(zt.files) == sorted(zj.files)
        for k in zj.files:
            assert zt[k].dtype == zj[k].dtype, k          # bf16: |V2 both
            assert zt[k].tobytes() == zj[k].tobytes(), k
    assert (tmp_path / "t" / "LATEST").read_text() == "3"


def test_each_package_restores_the_others_checkpoint(tmp_path):
    jt, tt = _trees()
    jck.save(str(tmp_path / "j"), 5, jt, extra={"data_cursor": 5})
    tck.save(str(tmp_path / "t"), 5, tt, extra={"data_cursor": 5})
    got, extra = tck.restore(str(tmp_path / "j"), tt)
    assert extra == {"data_cursor": 5}
    assert isinstance(got, tuple) and got[0]["embed"].dtype == torch.bfloat16
    assert got[1]["step"].dtype == torch.int32
    assert all(x.device.type == "cpu" for x in
               (got[0]["blocks"]["w"], got[0]["embed"], got[1]["step"]))
    _same(got, jt)
    back, extra = jck.restore(str(tmp_path / "t"), jt)
    assert extra == {"data_cursor": 5}
    assert str(back[0]["embed"].dtype) == "bfloat16"
    _same(back, tt)


def test_shards_split_where_the_reference_splits(monkeypatch, tmp_path):
    jt, tt = _trees()
    monkeypatch.setattr(jck, "_SHARD_BYTES", 100)
    monkeypatch.setattr(tck, "_SHARD_BYTES", 100)
    jck.save(str(tmp_path / "j"), 1, jt)
    tck.save(str(tmp_path / "t"), 1, tt)
    mj = json.loads((tmp_path / "j" / "step_000000001" / "manifest.json"
                     ).read_text())
    mt = json.loads((tmp_path / "t" / "step_000000001" / "manifest.json"
                     ).read_text())
    assert mt == mj and mt["n_shards"] > 1
    _same(tck.restore(str(tmp_path / "j"), tt)[0], jt)


def test_restore_refuses_mismatched_trees(tmp_path):
    _, tt = _trees()
    tck.save(str(tmp_path), 1, tt)
    with pytest.raises(KeyError, match="not in target tree"):
        tck.restore(str(tmp_path), (tt[0], {"m": tt[1]["m"]}))
    with pytest.raises(KeyError, match="missing from checkpoint"):
        tck.restore(str(tmp_path), (tt[0], {**tt[1], "v": tt[1]["m"]}))
    with pytest.raises(FileNotFoundError):
        tck.restore(str(tmp_path / "empty"), tt)


def test_save_async_snapshots_before_returning(monkeypatch, tmp_path):
    tree = {"x": torch.arange(6, dtype=torch.float32),
            "y": torch.ones(3, dtype=torch.bfloat16)}
    gate = threading.Event()
    write = tck._write

    def held(*a, **k):
        gate.wait(10)
        return write(*a, **k)

    monkeypatch.setattr(tck, "_write", held)
    th = tck.save_async(str(tmp_path), 2, tree)
    tree["x"].add_(100)                      # the caller goes on updating
    tree["y"].mul_(3)
    gate.set()
    th.join(10)
    assert not th.is_alive()
    got, _ = tck.restore(str(tmp_path), tree)
    np.testing.assert_array_equal(got["x"].numpy(), np.arange(6))
    assert torch.equal(got["y"], torch.ones(3, dtype=torch.bfloat16))


# --- the reference's own cases ------------------------------------------


def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(10, dtype=torch.float32),
            "b": {"c": torch.ones((3, 4), dtype=torch.bfloat16)},
            "step": torch.tensor(7, dtype=torch.int32)}
    tck.save(str(tmp_path), 3, tree, extra={"data_cursor": 3})
    restored, extra = tck.restore(str(tmp_path), tree)
    assert extra["data_cursor"] == 3
    np.testing.assert_array_equal(restored["a"].numpy(), np.arange(10))
    assert restored["b"]["c"].dtype == torch.bfloat16


def test_checkpoint_latest_pointer(tmp_path):
    tree = {"x": torch.zeros(2)}
    tck.save(str(tmp_path), 1, tree)
    tck.save(str(tmp_path), 5, tree)
    assert tck.latest_step(str(tmp_path)) == 5


def test_checkpoint_async(tmp_path):
    tree = {"x": torch.arange(5)}
    th = tck.save_async(str(tmp_path), 2, tree)
    th.join(10)
    assert not th.is_alive()
    restored, _ = tck.restore(str(tmp_path), tree)
    np.testing.assert_array_equal(restored["x"].numpy(), np.arange(5))


def test_supervisor_resumes_from_checkpoint(tmp_path):
    """Kill after a few steps; a fresh supervisor must resume, not restart."""
    calls = []

    def step_fn(params, opt, batch):
        params = {"w": params["w"] + 1}
        calls.append(int(params["w"][0]))
        return params, opt, {"loss": torch.tensor(1.0)}

    def batch_fn(step):
        return {}

    sup = TrainSupervisor(str(tmp_path), ckpt_every=2)
    p0 = {"w": torch.zeros(1)}
    p1, _ = sup.run(step_fn, p0, {}, batch_fn, n_steps=5)
    assert int(p1["w"][0]) == 5

    # second run resumes from the final checkpoint (step 5): no extra steps
    sup2 = TrainSupervisor(str(tmp_path), ckpt_every=2)
    p2, _ = sup2.run(step_fn, p0, {}, batch_fn, n_steps=5)
    assert int(p2["w"][0]) == 5
    assert calls == [1, 2, 3, 4, 5]
    assert sorted(os.listdir(tmp_path)) == [
        "LATEST", "step_000000002", "step_000000004", "step_000000005"]


def test_straggler_monitor():
    m = StragglerMonitor(alpha=0.5, factor=2.0)
    for s in range(5):
        assert not m.observe(s, 1.0)
    assert m.observe(5, 10.0)
    assert m.flagged and m.flagged[0][0] == 5


def test_elastic_remesh_shrinks_data_axis():
    mesh = elastic_remesh(1, model=1)
    assert mesh.shape["data"] == 1 and mesh.shape["model"] == 1
    assert mesh.axis_names == ("data", "model")
    assert mesh.devices.shape == (1, 1)
    assert isinstance(mesh.devices[0, 0], torch.device)
    # the reference's arithmetic: data = n // min(model, n)
    from repro.train.fault_tolerance import elastic_remesh as j_remesh
    for n, model in ((1, 16), (1, 1)):
        assert elastic_remesh(n, model=model).shape == \
            dict(j_remesh(n, model=model).shape)


def test_restore_across_mesh_change(tmp_path):
    """Checkpoints are mesh-agnostic: save, re-mesh after device loss,
    restore and place on the new layout's device."""
    tree = {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8)}
    tck.save(str(tmp_path), 1, tree)
    mesh = elastic_remesh(1, model=1)
    restored, _ = tck.restore(str(tmp_path), tree)
    placed = restored["w"].to(mesh.devices.flat[0])
    np.testing.assert_array_equal(placed.cpu().numpy(), tree["w"].numpy())


# --- the port's own duties ------------------------------------------------


def test_supervisor_retries_from_the_same_state(tmp_path):
    seen = []

    def flaky(params, opt, batch):
        seen.append(float(params["w"][0]))
        if len(seen) == 2:
            raise RuntimeError("transient")
        return {"w": params["w"] + 1}, opt, {"loss": torch.tensor(0.5)}

    sup = TrainSupervisor(str(tmp_path), ckpt_every=10)
    p, _ = sup.run(flaky, {"w": torch.zeros(1)}, {}, lambda s: {}, n_steps=3)
    assert seen == [0.0, 1.0, 1.0, 2.0] and float(p["w"][0]) == 3.0

    def broken(params, opt, batch):
        raise RuntimeError("persistent")

    sup = TrainSupervisor(str(tmp_path / "b"), max_retries=2)
    with pytest.raises(RuntimeError, match="persistent"):
        sup.run(broken, {"w": torch.zeros(1)}, {}, lambda s: {}, n_steps=1)


def test_restored_leaves_keep_the_live_trees_dtype(tmp_path):
    def step_fn(params, opt, batch):
        return ({"w": params["w"] + 1},
                {"step": opt["step"] + 1}, {"loss": torch.tensor(1.0)})

    params = {"w": torch.zeros(4, dtype=torch.bfloat16)}
    opt = {"step": torch.zeros((), dtype=torch.int32)}
    TrainSupervisor(str(tmp_path)).run(step_fn, params, opt, lambda s: {},
                                       n_steps=2)
    p, o = TrainSupervisor(str(tmp_path)).run(step_fn, params, opt,
                                              lambda s: {}, n_steps=3)
    assert p["w"].dtype == torch.bfloat16 and o["step"].dtype == torch.int32
    assert torch.equal(p["w"], torch.full((4,), 3.0, dtype=torch.bfloat16))
    assert int(o["step"]) == 3
