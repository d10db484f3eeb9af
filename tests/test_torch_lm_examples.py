"""The port's LM examples (``repro_torch.examples.{serve_lm,train_lm}``)
held to the reference's ``examples/{serve_lm,train_lm}.py``.

The reference examples run their CLIs under a mesh, which fails under the
installed jax (ROADMAP F2), so each is run here with its CLI stubbed to
record the arguments it passes (and, for ``train_lm``, the config it
registers and the line it prints); the CLIs' loops are replayed without
the mesh, as ``tests/test_torch_lm_{serve,train_cli}.py`` do.

Bounds: ``serve_lm``'s arguments equal the reference's (plus
``--device``) and its ``seqs`` equal the reference's loop exactly
(mamba2-370m smoke in float32 on JAX's weights, 6 steps); ``train_lm``'s
config equals the reference's field for field, its parameter count and
printed line exactly, its CLI arguments apart from ``--ckpt-dir`` and
``--device``; the config module is found by ``configs.get``; a 2-layer
cut of ``lm-100m`` at full width in float32 for 3 steps is within PR 25's
train bounds of the reference's loop (every loss within 1e-4 relative,
parameters within ``2 * lr * steps + 1e-6``).
"""
import dataclasses
import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm_harness import (assert_params_after_steps, assert_rel,
                               cfg_pair, jax_params, jax_params_jit, to_np)
from repro.launch import serve as jserve
from repro.launch import train as jtrain
from repro.launch.train import synthetic_batch_fn as j_batches
from repro.models import transformer as JT
from repro.train.fault_tolerance import TrainSupervisor as JSupervisor
from repro.train.optimizer import AdamWConfig, adamw_init
from repro.train.train_step import make_serve_step as j_make_serve_step
from repro.train.train_step import make_train_step
from repro_torch import configs as tconfigs
from repro_torch.examples import serve_lm, train_lm
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import transformer as TT
from repro_torch.models.common import params_from_numpy

ROOT = os.path.join(os.path.dirname(__file__), "..")


def _reference_example(name):
    spec = importlib.util.spec_from_file_location(
        f"_reference_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _record_calls(monkeypatch, module):
    calls = []
    monkeypatch.setattr(module, "main", lambda argv: calls.append(argv))
    return calls


@pytest.fixture
def lm100m_modules():
    """Drop the config modules the examples register."""
    yield
    for name in ("repro.configs.lm_100m", "repro_torch.configs.lm_100m"):
        sys.modules.pop(name, None)


# --- serve_lm -----------------------------------------------------------------


def test_serve_lm_passes_the_reference_arguments(monkeypatch):
    want = _record_calls(monkeypatch, jserve)
    got = _record_calls(monkeypatch, tserve)
    for flags in ([], ["--arch", "zamba2-1.2b", "--steps", "5"]):
        monkeypatch.setattr(sys, "argv", ["serve_lm.py", *flags])
        _reference_example("serve_lm").main()
        serve_lm.main([*flags, "--device", "cpu"])
        assert got[-1] == [*want[-1], "--device", "cpu"]


def test_serve_lm_seqs_equal_the_reference_loop(monkeypatch):
    jcfg, _ = cfg_pair("mamba2_370m")
    steps, batch, cache_len = 6, 4, 64
    params = jax_params(jcfg)
    cache = JT.zeros_cache(jcfg, batch, cache_len)
    step = jax.jit(j_make_serve_step(jcfg, greedy=True, temperature=1e-6))
    toks = jnp.asarray(
        np.random.default_rng(0).integers(1, jcfg.vocab, (batch, 1)),
        jnp.int32)
    rng = jax.random.PRNGKey(1)
    want = [np.asarray(toks)[:, 0]]
    for pos in range(steps):
        rng, sub = jax.random.split(rng)
        toks, _, cache = step(params, toks, cache, jnp.int32(pos), sub)
        want.append(np.asarray(toks)[:, 0])

    jp = to_np(params)
    monkeypatch.setattr(TT, "init_params", lambda cfg, gen: (
        params_from_numpy(jp, cfg, gen.device), None))
    smoke = tconfigs.get_smoke
    monkeypatch.setattr(tconfigs, "get_smoke", lambda name: (
        dataclasses.replace(smoke(name), param_dtype=torch.float32,
                            act_dtype=torch.float32)))
    got = serve_lm.main(["--steps", str(steps), "--device", "cpu"])
    np.testing.assert_array_equal(got, np.stack(want, 1))


# --- train_lm -----------------------------------------------------------------


def _reference_train_lm(monkeypatch):
    """Run the reference example with its CLI stubbed: (the module, the
    config it registered, the CLI's arguments)."""
    calls = _record_calls(monkeypatch, jtrain)
    monkeypatch.setattr(sys, "argv", ["train_lm.py"])
    ref = _reference_example("train_lm")
    ref.main()
    return ref, sys.modules["repro.configs.lm_100m"].CONFIG, calls[0]


def test_train_lm_matches_the_reference_example(monkeypatch, capsys,
                                                lm100m_modules):
    ref, jcfg, want = _reference_train_lm(monkeypatch)
    ref_line = capsys.readouterr().out
    got = _record_calls(monkeypatch, ttrain)
    train_lm.main(["--device", "cpu", "--ckpt-dir", "ck"])
    assert capsys.readouterr().out == ref_line

    tcfg = tconfigs.get("lm_100m")
    assert tcfg is train_lm.CONFIG is tconfigs.get_smoke("lm-100m")
    j, t = dataclasses.asdict(jcfg), dataclasses.asdict(tcfg)
    dtypes = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}
    for k in ("param_dtype", "act_dtype"):
        assert dtypes[j.pop(k)] == t.pop(k), k
    assert t == j

    n_ref = sum(int(np.prod(s.shape)) for s in ref._spec_leaves(jcfg))
    assert train_lm.n_params(tcfg) == n_ref
    assert ref_line == f"model: {n_ref / 1e6:.1f}M params\n"

    def opts(argv):
        return dict(zip(argv[::2], argv[1::2]))

    w, g = opts(want), opts(got[0])
    assert g.pop("--ckpt-dir") == "ck" and w.pop("--ckpt-dir")
    assert g.pop("--device") == "cpu"
    assert g == w and got[0][:2] == want[:2]


def test_train_lm_default_ckpt_dir_is_its_own(monkeypatch, lm100m_modules):
    got = _record_calls(monkeypatch, ttrain)
    train_lm.main(["--device", "cpu"])
    ckpt = got[0][got[0].index("--ckpt-dir") + 1]
    assert os.path.basename(ckpt) == "repro_torch_lm100m"


def test_train_lm_two_layers_match_the_reference_loop(monkeypatch, tmp_path,
                                                      lm100m_modules):
    """The example's flags (batch 4, seq 128, lr 1e-3) for 3 steps on a
    2-layer cut of lm-100m at full width, in float32."""
    steps, batch, seq, lr = 3, 4, 128, 1e-3
    tcfg = dataclasses.replace(train_lm.CONFIG, n_layers=2,
                               param_dtype=torch.float32,
                               act_dtype=torch.float32)
    _, jcfg, _ = _reference_train_lm(monkeypatch)
    jcfg = dataclasses.replace(jcfg, n_layers=2, param_dtype=jnp.float32,
                               act_dtype=jnp.float32)

    params = jax_params_jit(jcfg)
    opt_cfg = AdamWConfig(lr=lr, warmup_steps=min(20, steps // 10 + 1),
                          total_steps=steps)
    want_losses = []
    sup = JSupervisor(str(tmp_path / "ref"), ckpt_every=100)
    want, _ = sup.run(jax.jit(make_train_step(jcfg, opt_cfg)), params,
                      adamw_init(params, opt_cfg),
                      j_batches(jcfg, batch, seq), steps,
                      on_metrics=lambda s, m: want_losses.append(m["loss"]))

    jp = to_np(params)
    monkeypatch.setattr(train_lm, "CONFIG", tcfg)
    monkeypatch.setattr(TT, "init_params", lambda cfg, gen: (
        params_from_numpy(jp, cfg, gen.device), None))
    losses = []

    class Recording(ttrain.TrainSupervisor):
        def run(self, *a, on_metrics, **k):
            def both(step, m):
                losses.append(m["loss"])
                on_metrics(step, m)
            return super().run(*a, on_metrics=both, **k)

    monkeypatch.setattr(ttrain, "TrainSupervisor", Recording)
    got = train_lm.main(["--steps", str(steps), "--device", "cpu",
                         "--ckpt-dir", str(tmp_path / "port")])
    assert len(losses) == len(want_losses) == steps
    for i, (g, w) in enumerate(zip(losses, want_losses)):
        assert_rel(g, w, f"lm-100m loss at step {i}")
    assert_params_after_steps(got, want, lr, steps, "lm-100m", share=False)
