"""The LM scaffold's configs, parameter specs, initialisation and cache
layouts in the port, held to ``repro.configs`` / ``repro.models``.

Bounds: every config field equal (``jnp.bfloat16`` <-> ``torch.bfloat16``);
``cells()``, specs (shape, axes, init, scale) and cache layouts (shape,
dtype) equal; ``params_from_numpy`` exact for bf16 leaves.  No JAX
function is jitted here.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm_harness import to_np
from repro import configs as jconfigs
from repro.models import transformer as JT
from repro.models.common import ParamSpec as JSpec
from repro_torch import configs as tconfigs
from repro_torch.models import transformer as TT
from repro_torch.models.common import (ParamSpec, init_dense,
                                       params_from_numpy)

_DTYPES = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}


def _fields(cfg):
    out = dataclasses.asdict(cfg)
    for k in ("param_dtype", "act_dtype"):
        out[k] = _DTYPES.get(out[k], out[k])
    return out


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_configs_match_field_for_field(arch):
    for get in ("get", "get_smoke"):
        want = getattr(jconfigs, get)(arch)
        got = getattr(tconfigs, get)(arch.replace("_", "-"))
        assert _fields(got) == _fields(want), get
        assert (got.head_dim, got.d_inner, got.ssm_heads,
                got.bytes_per_param()) == (
            want.head_dim, want.d_inner, want.ssm_heads,
            want.bytes_per_param())


def test_config_tables_and_cells_match():
    assert tconfigs.ARCHS == jconfigs.ARCHS
    assert tconfigs.SHAPES == jconfigs.SHAPES
    assert tconfigs.LONG_CONTEXT_OK == jconfigs.LONG_CONTEXT_OK
    for skipped in (False, True):
        assert tconfigs.cells(skipped) == jconfigs.cells(skipped)
    assert tconfigs.canon("qwen2.5-3b") == jconfigs.canon("qwen2.5-3b")


def _spec_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _spec_leaves(tree[k], (*path, k))
    else:
        yield path, tree


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_init_spec_matches_at_full_size(arch):
    want = dict(_spec_leaves(JT.init_spec(jconfigs.get(arch))))
    got = dict(_spec_leaves(TT.init_spec(tconfigs.get(arch))))
    assert list(got) == list(want)
    for path, w in want.items():
        g = got[path]
        assert isinstance(w, JSpec) and isinstance(g, ParamSpec)
        assert (g.shape, g.axes, g.init, g.scale) == (
            w.shape, w.axes, w.init, w.scale), path


def _dtype_name(d) -> str:
    """'bfloat16', 'int8', 'float32' for a numpy or a torch dtype."""
    return str(d).rsplit(".", 1)[-1]


def _cache_layout(tree):
    return {"/".join(p): (tuple(s.shape), _dtype_name(s.dtype))
            for p, s in _spec_leaves(tree)}


def _nbytes(tree):
    return sum(int(np.prod(s.shape)) * s.dtype.itemsize
               for _, s in _spec_leaves(tree))


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_init_cache_matches_at_full_size(arch):
    for kv_quant in (False, True):
        jc = dataclasses.replace(jconfigs.get(arch), kv_quant=kv_quant)
        tc = dataclasses.replace(tconfigs.get(arch), kv_quant=kv_quant)
        for b, length in ((8, 4096), (1, 32768)):
            want = _cache_layout(JT.init_cache(jc, b, length))
            got_tree = TT.init_cache(tc, b, length)
            assert all(s.device.type == "meta"
                       for _, s in _spec_leaves(got_tree))
            assert _cache_layout(got_tree) == want, (kv_quant, b, length)
            assert _nbytes(got_tree) == _nbytes(JT.init_cache(jc, b, length))


def test_int8_cache_is_smaller():
    cfg = tconfigs.get("qwen2.5-3b")
    full = _nbytes(TT.init_cache(cfg, 8, 4096))
    quant = _nbytes(TT.init_cache(dataclasses.replace(cfg, kv_quant=True),
                                  8, 4096))
    assert quant < 0.6 * full


def test_zeros_cache_is_zero_and_on_the_device():
    cfg = tconfigs.get_smoke("zamba2_1_2b")
    cache = TT.zeros_cache(cfg, 2, 128, "cpu")
    layout = _cache_layout(TT.init_cache(cfg, 2, 128))
    assert _cache_layout(cache) == layout
    for _, a in _spec_leaves(cache):
        assert a.device.type == "cpu" and not a.any()
    # the shared-attention ring holds the smoke window, not the length
    assert cache["shared_kv"]["k"].shape[2] == cfg.sliding_window


def test_init_dense_draws_the_reference_distribution():
    spec = {"w": ParamSpec((4000, 64), ("embed", "mlp"), scale=0.5),
            "b": {"ones": ParamSpec((7,), ("x",), init="ones"),
                  "zeros": ParamSpec((3, 5), (None, "x"), init="zeros")},
            "v": ParamSpec((9,), ("x",))}
    gen = torch.Generator("cpu").manual_seed(0)
    params, axes = init_dense(gen, spec, torch.bfloat16)
    assert axes == {"w": ("embed", "mlp"), "b": {"ones": ("x",),
                    "zeros": (None, "x")}, "v": ("x",)}
    w = params["w"]
    assert w.dtype == torch.bfloat16 and w.shape == (4000, 64)
    std = float(w.float().std())
    assert abs(std - 0.5 / np.sqrt(4000)) < 0.02 * 0.5 / np.sqrt(4000)
    assert torch.equal(params["b"]["ones"], torch.ones(7, dtype=torch.bfloat16))
    assert not params["b"]["zeros"].any()
    again, _ = init_dense(torch.Generator("cpu").manual_seed(0), spec,
                          torch.bfloat16)
    assert all(torch.equal(a, b) for (_, a), (_, b) in
               zip(_spec_leaves(params), _spec_leaves(again)))


def test_params_from_numpy_carries_bf16_exactly():
    jcfg = jconfigs.get_smoke("deepseek_v3_671b")
    tcfg = tconfigs.get_smoke("deepseek_v3_671b")
    jp, _ = JT.init_params(jcfg, jax.random.PRNGKey(0))
    leaves = dict(_spec_leaves(jp))
    tp = params_from_numpy(to_np(jp), tcfg, "cpu")
    got = dict(_spec_leaves(tp))
    assert list(got) == list(leaves)
    for path, a in leaves.items():
        g = got[path]
        assert g.dtype == torch.bfloat16 and tuple(g.shape) == a.shape
        back = jnp.asarray(g.float().numpy()).astype(jnp.bfloat16)
        assert bool(jnp.all(back == a)), path


def test_entry_points_refuse_cuda_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = tconfigs.get_smoke("qwen2_0_5b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TT.zeros_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_numpy({"w": np.zeros(3, np.float32)}, cfg, "cuda")
