"""Qwen2-0.5B [arXiv:2407.10671; hf]: 24L d896 14H GQA kv=2, d_ff 4864,
vocab 151936, QKV bias, tied embeddings."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b",
    family="dense",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv=2,
    d_ff=4864,
    vocab=151936,
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1000000.0,
)

SMOKE = ModelConfig(
    name="qwen2-smoke",
    family="dense",
    n_layers=2,
    d_model=56,
    n_heads=4,
    n_kv=2,
    d_ff=128,
    vocab=256,
    qkv_bias=True,
    tie_embeddings=True,
    loss_chunk=32,
)
