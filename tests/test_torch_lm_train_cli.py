"""The port's train CLI (``repro_torch.launch.train.main``) held to the
reference CLI's loop, composed here without its mesh and rules (the
reference CLI itself fails under the installed jax, ROADMAP F2):
``synthetic_batch_fn``, ``TrainSupervisor``, ``make_train_step`` under
``jax.jit``, ``AdamWConfig`` and ``adamw_init`` of ``repro``, on the same
weights (the port's ``init_params`` patched to carry the reference's
across) and the smoke config in float32.  A second run on the same
directory resumes at ``--steps`` and takes no step.

Bounds (``tests/_torch_lm_harness.py``): every step's loss within 1e-4
relative; the final parameters within ``2 * lr * steps + 1e-6`` of the
reference's (the share of elements within 1e-5 is held step by step in
``tests/test_torch_lm_train_step.py``, which says why not after several
free-running steps); the printed lines those of the reference's format; the resumed run's
parameters bit-equal to the first run's.
"""
import dataclasses
import re

import jax
import numpy as np
import pytest
import torch

from _torch_lm_harness import (assert_params_after_steps, assert_rel,
                               cfg_pair, jax_params_jit, to_np)
from repro import configs as jconfigs
from repro.launch.train import synthetic_batch_fn as j_batches
from repro.train.fault_tolerance import TrainSupervisor as JSupervisor
from repro.train.optimizer import AdamWConfig, adamw_init
from repro.train.train_step import make_train_step
from repro_torch import configs as tconfigs
from repro_torch.launch import train as ttrain
from repro_torch.models import transformer as TT
from repro_torch.models.common import params_from_numpy


def _reference_loop(jcfg, ckpt_dir, steps, batch, seq, lr=3e-4,
                    ckpt_every=50, microbatches=1, compress=False):
    """``repro.launch.train.main``'s loop without its mesh; returns the
    final params and every step's loss."""
    if jcfg.family == "encdec":
        seq = min(seq, jcfg.max_target_len)
    params = jax_params_jit(jcfg)
    opt_cfg = AdamWConfig(lr=lr, warmup_steps=min(20, steps // 10 + 1),
                          total_steps=steps)
    step_fn = jax.jit(make_train_step(jcfg, opt_cfg,
                                      microbatches=microbatches,
                                      compress_grads=compress))
    losses = []
    sup = JSupervisor(str(ckpt_dir), ckpt_every=ckpt_every)
    params, _ = sup.run(step_fn, params, adamw_init(params, opt_cfg),
                        j_batches(jcfg, batch, seq), steps,
                        on_metrics=lambda s, m: losses.append(m["loss"]))
    return params, losses


def _port_cli(monkeypatch, jcfg, argv):
    """The port's CLI on the CPU with the reference's weights and the
    smoke config in float32; returns the params and every step's loss."""
    jp = to_np(jax_params_jit(jcfg))
    monkeypatch.setattr(TT, "init_params", lambda cfg, gen: (
        params_from_numpy(jp, cfg, gen.device), None))
    smoke = tconfigs.get_smoke
    monkeypatch.setattr(tconfigs, "get_smoke", lambda name: (
        dataclasses.replace(smoke(name), param_dtype=torch.float32,
                            act_dtype=torch.float32)))
    losses = []

    class Recording(ttrain.TrainSupervisor):
        def run(self, *a, on_metrics, **k):
            def both(step, m):
                losses.append(m["loss"])
                on_metrics(step, m)
            return super().run(*a, on_metrics=both, **k)

    monkeypatch.setattr(ttrain, "TrainSupervisor", Recording)
    params = ttrain.main([*argv, "--smoke", "--device", "cpu"])
    return params, losses


LINE = r"step +(\d+)  loss (\d+\.\d{4})  gnorm (\d+\.\d{2})  dt \d+ms$"


@pytest.mark.parametrize("arch,flags", [
    # tests/test_drivers.py's two train cases
    ("qwen2-0.5b", ("--steps", "3", "--batch", "2", "--seq", "32",
                    "--ckpt-every", "2")),
    ("stablelm-3b", ("--steps", "2", "--batch", "4", "--seq", "32",
                     "--microbatches", "2", "--compress-grads")),
    # the log's 10-step cadence, async saves at 4 and 8 and the final one
    ("qwen2-0.5b", ("--steps", "11", "--batch", "2", "--seq", "64",
                    "--ckpt-every", "4")),
    ("whisper-tiny", ("--steps", "3", "--batch", "2", "--seq", "64")),
])
def test_cli_matches_the_reference_loop(monkeypatch, capsys, tmp_path,
                                        arch, flags):
    opts = dict(zip(flags[::2], flags[1::2]))
    steps, batch, seq = (int(opts[k]) for k in ("--steps", "--batch",
                                                 "--seq"))
    jcfg, _ = cfg_pair(jconfigs.canon(arch))
    want, want_losses = _reference_loop(
        jcfg, tmp_path / "ref", steps, batch, seq,
        ckpt_every=int(opts.get("--ckpt-every", 50)),
        microbatches=int(opts.get("--microbatches", 1)),
        compress="--compress-grads" in flags)
    argv = ["--arch", arch, *flags, "--ckpt-dir", str(tmp_path / "port")]
    got, losses = _port_cli(monkeypatch, jcfg, argv)
    assert len(losses) == len(want_losses) == steps
    for i, (g, w) in enumerate(zip(losses, want_losses)):
        assert_rel(g, w, f"{arch} loss at step {i}")
    assert_params_after_steps(got, want, 3e-4, steps, arch, share=False)

    lines = capsys.readouterr().out.splitlines()
    logged = [ln for ln in lines if ln.startswith("step")]
    assert [int(re.match(LINE, ln).group(1)) for ln in logged] == \
        list(range(0, steps, 10))
    for ln in logged:
        s = int(re.match(LINE, ln).group(1))
        assert float(re.match(LINE, ln).group(2)) == \
            pytest.approx(losses[s], abs=5e-5)
    k = max(steps // 10, 1)
    assert [ln for ln in lines if ln.startswith("first-")] == [
        f"first-{k} mean loss {np.mean(losses[:k]):.4f} -> "
        f"last-{k} mean {np.mean(losses[-k:]):.4f}"]

    # a second run on the same directory resumes at --steps: no step
    again, more = _port_cli(monkeypatch, jcfg, argv)
    assert more == [] and capsys.readouterr().out == ""
    for a, b in zip(_leaves(again), _leaves(got)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def test_cli_refuses_a_host_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(["--smoke", "--steps", "1", "--ckpt-dir",
                     str(tmp_path)])
