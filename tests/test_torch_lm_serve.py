"""The LM scaffold's serving path in the port: ``make_serve_step`` (greedy
and sampled) and the serve CLI (``repro_torch.launch.serve``), held to
``repro.train.train_step.make_serve_step`` and to the reference CLI's loop
(``repro.launch.serve.main``) replayed without its mesh, which fails under
the installed jax (ROADMAP F2).

Bounds: float32 smoke configs; next tokens and ``seqs`` exactly equal;
logits and caches within ``F32 = 1e-4`` times ``max(1, max|ref|)``; the
sampler's threefry bits and uniforms exactly equal, its Gumbel noise
within 1e-6 absolute and relative (``log`` is XLA's on one side, torch's
on the other: a few ulps).  The bf16 CLI (the config's own dtype) picks,
at every step, a token whose reference logit is within ``2 * BF16`` of
the reference's largest.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm_harness import (BF16, assert_close, cfg_pair, jax_params,
                               params_pair, t, to_np)
from repro import configs as jconfigs
from repro.models import transformer as JT
from repro.train.train_step import make_serve_step as j_make_serve_step
from repro_torch import configs as tconfigs
from repro_torch.core import prng
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as TT
from repro_torch.models.common import params_from_numpy
from repro_torch.train.train_step import make_serve_step


@pytest.mark.parametrize("arch,greedy", [
    ("qwen2_0_5b", True), ("qwen2_0_5b", False), ("deepseek_v3_671b", True),
    ("zamba2_1_2b", False)])
def test_serve_step_matches(arch, greedy):
    jcfg, tcfg = cfg_pair(arch)
    jp, tp = params_pair(jcfg, tcfg)
    jstep = jax.jit(j_make_serve_step(jcfg, greedy=greedy, temperature=0.8))
    tstep = make_serve_step(tcfg, greedy=greedy, temperature=0.8)
    b, length = 3, 16
    jc, tc = JT.zeros_cache(jcfg, b, length), TT.zeros_cache(tcfg, b,
                                                              length, "cpu")
    toks = np.random.default_rng(2).integers(1, jcfg.vocab, (b, 1))
    jt, tt = jnp.asarray(toks, jnp.int32), t(toks, torch.int32)
    jkey, tkey = jax.random.PRNGKey(7), prng.prng_key(7)
    for pos in range(5):
        jkey, jsub = jax.random.split(jkey)
        tkey, tsub = prng.split(tkey)
        jt, jl, jc = jstep(jp, jt, jc, jnp.int32(pos), jsub)
        tt, tl, tc = tstep(tp, tt, tc, pos, tsub)
        assert tt.dtype == torch.int32 and tt.shape == (b, 1)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        assert_close(tl, jl, what=f"logits at {pos}")
        assert_close(tc, jc, what=f"cache at {pos}")


def test_sampler_draws_jax_bits():
    key = jax.random.PRNGKey(1)
    tkey = prng.prng_key(1)
    tiny = float(np.finfo(np.float32).tiny)
    logits = np.random.default_rng(0).normal(0, 2, (4, 1000))
    logits = logits.astype(np.float32)
    for _ in range(4):
        key, sub = jax.random.split(key)
        tkey, tsub = prng.split(tkey)
        np.testing.assert_array_equal(tsub.numpy(),
                                      np.asarray(sub).astype(np.int64))
        np.testing.assert_array_equal(
            prng.random_bits(tsub, (4, 1000)).numpy(),
            np.asarray(jax.random.bits(sub, (4, 1000))).astype(np.int64))
        np.testing.assert_array_equal(
            prng.uniform(tsub, (4, 1000), tiny, 1.0).numpy(),
            np.asarray(jax.random.uniform(sub, (4, 1000), jnp.float32,
                                          tiny, 1.0)))
        g_j = np.asarray(jax.random.gumbel(sub, (4, 1000), jnp.float32))
        g_t = prng.gumbel(tsub, (4, 1000)).numpy()
        np.testing.assert_allclose(g_t, g_j, rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(
            prng.categorical(tsub, t(logits) / 0.8).numpy(),
            np.asarray(jax.random.categorical(sub, jnp.asarray(logits) / 0.8,
                                              axis=-1)))


def _reference_cli(jcfg, batch=4, steps=32, cache_len=128, temperature=0.0):
    """``repro.launch.serve.main``'s loop without its mesh and rules."""
    params = jax_params(jcfg)
    cache = JT.zeros_cache(jcfg, batch, cache_len)
    step = jax.jit(j_make_serve_step(jcfg, greedy=temperature == 0.0,
                                     temperature=max(temperature, 1e-6)))
    toks = jnp.asarray(
        np.random.default_rng(0).integers(1, jcfg.vocab, (batch, 1)),
        jnp.int32)
    rng = jax.random.PRNGKey(1)
    seqs = [np.asarray(toks)[:, 0]]
    for pos in range(steps):
        rng, sub = jax.random.split(rng)
        toks, _, cache = step(params, toks, cache, jnp.int32(pos), sub)
        seqs.append(np.asarray(toks)[:, 0])
    return np.stack(seqs, 1)


def _port_cli(monkeypatch, jcfg, argv, f32=True):
    """The port's CLI with the reference's weights (and, for float32, the
    smoke config in float32)."""
    jp = to_np(jax_params(jcfg))
    monkeypatch.setattr(TT, "init_params", lambda cfg, gen: (
        params_from_numpy(jp, cfg, gen.device), None))
    if f32:
        smoke = tconfigs.get_smoke
        monkeypatch.setattr(tconfigs, "get_smoke", lambda name: (
            dataclasses.replace(smoke(name), param_dtype=torch.float32,
                                act_dtype=torch.float32)))
    return tserve.main([*argv, "--smoke", "--device", "cpu"])


@pytest.mark.parametrize("arch,flags", [
    ("qwen2-0.5b", ()), ("qwen2-0.5b", ("--kv-quant",)),
    ("qwen2-0.5b", ("--temperature", "0.8")),
    ("olmoe-1b-7b", ("--steps", "8")), ("deepseek-v3-671b", ("--steps", "8")),
    ("whisper-tiny", ("--steps", "8", "--kv-quant")),
    ("mamba2-370m", ("--steps", "8")), ("zamba2-1.2b", ("--steps", "8"))])
def test_cli_matches_the_reference_loop(monkeypatch, capsys, arch, flags):
    kv_quant = "--kv-quant" in flags
    temperature = float(flags[-1]) if "--temperature" in flags else 0.0
    steps = int(flags[1]) if "--steps" in flags else 32
    jcfg, _ = cfg_pair(jconfigs.canon(arch), kv_quant=kv_quant)
    want = _reference_cli(jcfg, steps=steps, temperature=temperature)
    got = _port_cli(monkeypatch, jcfg, ["--arch", arch, *flags])
    assert got.dtype == want.dtype and got.shape == (4, steps + 1)
    np.testing.assert_array_equal(got, want)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith(f"decoded {steps} steps x batch 4 in ")
    assert lines[1:] == [f"  seq[{b}]: {want[b, :16].tolist()}..."
                         for b in range(4)]


def test_bf16_cli_picks_near_argmax_tokens(monkeypatch, capsys):
    jcfg = jconfigs.get_smoke("qwen2_0_5b")
    got = _port_cli(monkeypatch, jcfg, ["--steps", "16"], f32=False)
    capsys.readouterr()
    params = jax_params(jcfg)
    step = jax.jit(lambda p, x, c, pos: JT.forward_decode(p, x, c, pos,
                                                          jcfg))
    cache = JT.zeros_cache(jcfg, 4, 128)
    for pos in range(16):
        logits, cache = step(params, jnp.asarray(got[:, pos:pos + 1]),
                             cache, jnp.int32(pos))
        lf = np.asarray(logits[:, -1].astype(jnp.float32))
        picked = lf[np.arange(4), got[:, pos + 1]]
        assert np.all(picked >= lf.max(-1) - 2 * BF16), pos


def test_cli_refuses_a_host_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["--smoke", "--steps", "1"])
