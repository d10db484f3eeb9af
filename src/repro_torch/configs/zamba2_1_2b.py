"""Zamba2-1.2B [arXiv:2411.15242; hf]: 38L Mamba2 backbone d2048
(ssm_state 64) + ONE shared attention+MLP block (32H kv=32, d_ff 8192)
invoked every 6 layers with concat(h, embed) input, vocab 32000.

For the long_500k decode shape the shared attention uses an 8k sliding
window (ring-buffer KV) — noted as a hardware adaptation in DESIGN.md."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv=32,
    d_ff=8192,
    vocab=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_conv=4,
    ssm_chunk=256,
    shared_attn_every=6,
    sliding_window=8192,
)

SMOKE = ModelConfig(
    name="zamba2-smoke",
    family="hybrid",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv=4,
    d_ff=128,
    vocab=256,
    ssm_state=16,
    ssm_expand=2,
    ssm_headdim=16,
    ssm_conv=4,
    ssm_chunk=16,
    shared_attn_every=2,
    sliding_window=64,
    loss_chunk=32,
)
