"""Shared by ``tests/test_torch_dryrun_{counter,decode,train}.py``: the same smoke
program counted by the reference (``analyze_hlo`` of its single-device,
no-mesh compile on the CPU) and by the port (``analyze`` of one run on
fake tensors), and the products the two may name apart.

The reference's lowering under a mesh fails under the installed jax (F2),
so its no-mesh compile is what the port's counter is held to: dot FLOPs
exactly equal, or apart by the products ``named_gap`` computes from the
config, and nothing else.

* F10 (zamba2): the reference applies the shared block through a
  ``lax.cond`` in the layer scan, and ``analyze_hlo`` weighs both branches
  of a conditional by the enclosing loop's trip count, so it counts the
  shared block on every layer, where it runs on ``n_layers //
  shared_attn_every`` of them; the port counts what runs.  An untaken
  layer costs the block's forward products, and in a train step also their
  two backward products each and the recompute of its batched products
  (remat ``dots`` saves only the unbatched ones).
* The SSD backward (every SSM layer of a train step): the reference's
  compiled backward holds, per layer, three more products over the
  intra-chunk (B, NC, H, Q, Q) decay products, of 2*B*NC*H*Q*Q FLOPs each,
  and one more of 2*B*NC*H*Q*Q*P, which the port computes as elementwise
  multiplies and sums (XLA's algebraic simplifier rewrites multiply-reduce
  as dots).
"""
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro import configs as jconfigs
from repro.models import transformer as JT
from repro.train.optimizer import AdamWConfig as JAdamW
from repro.train.train_step import make_serve_step as j_serve
from repro.train.train_step import make_train_step as j_train
from repro.utils.hlo_analysis import analyze_hlo
from repro_torch import configs as tconfigs
from repro_torch.models import transformer as TT
from repro_torch.models.common import tree_map
from repro_torch.train.optimizer import AdamWConfig as TAdamW
from repro_torch.train.train_step import make_serve_step as t_serve
from repro_torch.train.train_step import make_train_step as t_train
from repro_torch.utils.hlo_analysis import analyze

B, S = 2, 64          # batch, and sequence / cache length

_FUTURES: dict = {}


def compile_references(cases):
    """Start the reference's compiles of ``cases`` ((arch, kind) pairs) on
    two threads, so that they run while the port's programs are counted;
    returns the pool, for the caller to shut down."""
    pool = ThreadPoolExecutor(max_workers=2)
    for case in cases:
        if case not in _FUTURES:
            _FUTURES[case] = pool.submit(_reference_dot_flops, *case)
    return pool


def reference_dot_flops(arch: str, kind: str) -> float:
    """``analyze_hlo(...).dot_flops`` of the reference's compiled smoke
    program: ``forward_prefill``, the serve step on a cache of ``S``, or
    the train step with float32 AdamW state."""
    if (arch, kind) not in _FUTURES:
        compile_references([(arch, kind)]).shutdown(wait=False)
    return _FUTURES[(arch, kind)].result()


def _reference_dot_flops(arch: str, kind: str) -> float:
    cfg = jconfigs.get_smoke(arch)
    ap, _ = JT.abstract_params(cfg)
    if kind == "prefill":
        batch = JT.input_specs(cfg, kind, S, B)
        low = jax.jit(lambda p, b: JT.forward_prefill(p, b, cfg)).lower(
            ap, batch)
    elif kind == "decode":
        sp = JT.input_specs(cfg, kind, S, B)
        low = jax.jit(j_serve(cfg)).lower(
            ap, sp["tokens"], sp["cache"], sp["pos"],
            jax.ShapeDtypeStruct((2,), jnp.uint32))
    else:
        batch = JT.input_specs(cfg, kind, S, B)
        f32 = jax.tree.map(
            lambda p: jax.ShapeDtypeStruct(p.shape, jnp.float32), ap)
        opt = {"m": f32, "v": f32, "step": jax.ShapeDtypeStruct((),
                                                                jnp.int32)}
        low = jax.jit(j_train(cfg, JAdamW())).lower(ap, opt, batch)
    return analyze_hlo(low.compile().as_text()).dot_flops


def port_stats(arch: str, kind: str):
    """``analyze`` of the port's same program, once, on fake tensors."""
    cfg = tconfigs.get_smoke(arch)
    mode = FakeTensorMode(allow_non_fake_inputs=True)

    def fake(tree, dtype=None):
        def one(m):
            with mode:
                return torch.empty(m.shape, dtype=dtype or m.dtype)
        return tree_map(one, tree)

    ap, _ = TT.abstract_params(cfg)
    params = fake(ap)
    if kind == "prefill":
        batch = fake(TT.input_specs(cfg, kind, S, B))
        return analyze(lambda p, b: TT.forward_prefill(p, b, cfg), params,
                       batch)[1]
    if kind == "decode":
        sp = TT.input_specs(cfg, kind, S, B)
        return analyze(t_serve(cfg), params, fake(sp["tokens"]),
                       fake(sp["cache"]), S - 1, None)[1]
    batch = fake(TT.input_specs(cfg, kind, S, B))
    opt = {"m": fake(ap, torch.float32), "v": fake(ap, torch.float32),
           "step": fake(torch.empty((), dtype=torch.int32, device="meta"))}
    return analyze(t_train(cfg, TAdamW()), params, opt, batch)[1]


def _shared_block(cfg):
    """(all products, batched products) of one application of zamba2's
    shared block on a (B, S) batch."""
    d, h, kv, dh, ff = (cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim,
                        cfg.d_ff)
    t = B * S
    unbatched = (2 * t * 2 * d * d                 # in_proj
                 + 2 * t * d * (h + 2 * kv) * dh    # q, k, v
                 + 2 * t * h * dh * d               # out
                 + 3 * 2 * t * d * ff)              # gate, up, down
    batched = 2 * (2 * B * h * S * S * dh)         # scores, values
    return unbatched + batched, batched


def named_gap(arch: str, kind: str) -> float:
    """Reference minus port dot FLOPs, by the named products (see the
    module docstring); 0 where the two count the same program."""
    cfg = tconfigs.get_smoke(arch)
    gap = 0
    if cfg.family == "hybrid" and kind != "decode":
        untaken = cfg.n_layers - cfg.n_layers // cfg.shared_attn_every
        fwd, batched = _shared_block(cfg)
        gap += untaken * (fwd if kind == "prefill" else 3 * fwd + batched)
    if cfg.family in ("ssm", "hybrid") and kind == "train":
        h, q, p = cfg.ssm_heads, cfg.ssm_chunk, cfg.ssm_headdim
        decay = 2 * B * (S // q) * h * q * q
        gap += cfg.n_layers * (3 * decay + decay * p)
    return float(gap)
