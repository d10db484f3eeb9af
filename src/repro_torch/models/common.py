"""Model substrate of the LM scaffold (the port of ``repro.models.common``):
the config, parameter specs with logical axis names, norms, RoPE.

Parameters are nested dicts of tensors; every leaf comes from a
``ParamSpec`` carrying its logical axes.  Per-layer parameters are stacked
on a leading 'layers' axis, as in the reference, and the model code walks
that axis in a Python loop.  dtype policy: parameters and activations
bf16 by default; norms, softmax and the other reductions in float32.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.state import resolve_device

__all__ = [
    "ModelConfig",
    "ParamSpec",
    "init_dense",
    "params_from_numpy",
    "rms_norm",
    "layer_norm",
    "make_rope",
    "apply_rope",
    "sinusoidal_positions",
    "Axes",
]

Axes = tuple[Optional[str], ...]


# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One config describes every architecture family in the zoo."""

    name: str = "model"
    family: str = "dense"        # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv: int = 4
    d_head: int = 0              # 0 -> d_model // n_heads
    d_ff: int = 1024
    vocab: int = 32000
    qkv_bias: bool = False
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    max_seq: int = 131072

    # --- MoE ---------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    d_expert: int = 0            # expert FF width (may differ from d_ff)
    n_shared_experts: int = 0
    router_aux_weight: float = 0.001
    moe_a2a: bool = False        # all-to-all expert dispatch (needs a mesh)

    # --- MLA (DeepSeek) ----------------------------------------------------
    mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    mtp: bool = False            # multi-token-prediction auxiliary head

    # --- SSM (Mamba2 / SSD) --------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256

    # --- hybrid (Zamba2) -----------------------------------------------------
    shared_attn_every: int = 0   # shared attention block period (0 = none)

    # --- encoder-decoder (Whisper) -------------------------------------------
    n_enc_layers: int = 0
    n_audio_frames: int = 1500
    max_target_len: int = 448

    # --- vision (Phi-3-vision) -----------------------------------------------
    n_img_tokens: int = 0        # patch-embedding stub slots per sample

    # --- attention behaviour --------------------------------------------------
    sliding_window: int = 0      # 0 = full causal; >0 = window (hybrid 500k)
    attn_chunk: int = 0          # blockwise attention chunk (0 = default)
    kv_quant: bool = False       # int8 KV cache for decode

    # --- numerics / training ---------------------------------------------------
    param_dtype: Any = torch.bfloat16
    act_dtype: Any = torch.bfloat16
    remat: str = "dots"          # none | dots | full
    loss_chunk: int = 512        # sequence chunk for the CE loss

    @property
    def head_dim(self) -> int:
        if self.n_heads == 0:
            return self.d_head    # attention-free (SSM) families
        return self.d_head or self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def bytes_per_param(self) -> int:
        return self.param_dtype.itemsize


# ---------------------------------------------------------------------------
# Param creation with logical axes
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: Axes
    init: str = "normal"         # normal | zeros | ones | small
    scale: float = 1.0


def _leaves(tree, path=()):
    """(path, leaf) pairs in the reference's flatten order (sorted keys)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], (*path, k))
    else:
        yield path, tree


def _set(tree: dict, path: tuple, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _init_leaf(gen: torch.Generator, spec: ParamSpec, dtype) -> torch.Tensor:
    dev = gen.device
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=dev)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=dev)
    fan_in = spec.shape[0] if len(spec.shape) >= 2 else max(spec.shape[0], 1)
    std = float(np.float32(spec.scale / np.sqrt(fan_in)))
    x = torch.randn(spec.shape, generator=gen, dtype=torch.float32,
                    device=dev)
    return (x * std).to(dtype)


def init_dense(gen: torch.Generator, tree_spec: dict, dtype
               ) -> tuple[dict, dict]:
    """Materialise (params, logical_axes) trees from a spec tree.

    Each leaf is drawn from ``gen`` (on its device) in the reference's
    flatten order, with the reference's shape, dtype and std: a float32
    normal times ``scale / sqrt(fan_in)``, cast to ``dtype``.  The values
    are torch's, not JAX's; ``params_from_numpy`` carries JAX's across.
    """
    params: dict = {}
    axes: dict = {}
    for path, spec in _leaves(tree_spec):
        _set(params, path, _init_leaf(gen, spec, dtype))
        _set(axes, path, spec.axes)
    return params, axes


def params_from_numpy(tree: dict, cfg: ModelConfig, device) -> dict:
    """The reference's parameters, as float32 numpy arrays under the same
    keys and stacked shapes, as a parameter tree of ``cfg.param_dtype`` on
    ``device``.  A bf16 leaf survives the bf16 -> f32 -> bf16 trip
    exactly."""
    dev = resolve_device(device)
    out: dict = {}
    for path, a in _leaves(tree):
        t = torch.from_numpy(np.asarray(a, np.float32).copy())
        _set(out, path, t.to(device=dev, dtype=cfg.param_dtype))
    return out


def tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts of equal structure."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float
             ) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * gamma.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * gamma.float() + beta.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def make_rope(positions: torch.Tensor, dim: int, theta: float
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., S) int positions -> cos/sin tables (..., S, dim/2), f32."""
    dev = positions.device
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=dev) / dim
    # theta ** exps rounded once to float32 (float64 pow), as a correctly
    # rounding float32 pow gives it
    inv = 1.0 / torch.pow(float(theta), exps.double()).float()
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x: (..., S, H, D); cos/sin: (..., S, D/2) broadcast over heads."""
    d2 = x.shape[-1] // 2
    c = cos[..., None, :]
    s = sin[..., None, :]
    xf1 = x[..., :d2].float()
    xf2 = x[..., d2:].float()
    out = torch.cat([xf1 * c - xf2 * s, xf2 * c + xf1 * s], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(n: int, d: int) -> np.ndarray:
    """Whisper-style fixed positional embeddings."""
    pos = np.arange(n)[:, None]
    i = np.arange(d // 2)[None, :]
    ang = pos / (10000 ** (2 * i / d))
    out = np.zeros((n, d), np.float32)
    out[:, 0::2] = np.sin(ang)
    out[:, 1::2] = np.cos(ang)
    return out
