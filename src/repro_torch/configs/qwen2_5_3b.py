"""Qwen2.5-3B [arXiv:2407.10671 family; hf]: 36L d2048 16H GQA kv=2,
d_ff 11008, vocab 151936, QKV bias."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b",
    family="dense",
    n_layers=36,
    d_model=2048,
    n_heads=16,
    n_kv=2,
    d_ff=11008,
    vocab=151936,
    qkv_bias=True,
    rope_theta=1000000.0,
)

SMOKE = ModelConfig(
    name="qwen25-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv=2,
    d_ff=128,
    vocab=256,
    qkv_bias=True,
    loss_chunk=32,
)
