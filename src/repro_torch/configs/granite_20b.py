"""Granite-20B (code) [arXiv:2405.04324; hf]: 52L d6144 48H MQA (kv=1),
d_ff 24576, vocab 49152."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    family="dense",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv=1,
    d_ff=24576,
    vocab=49152,
    rope_theta=10000.0,
)

SMOKE = ModelConfig(
    name="granite-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv=1,
    d_ff=128,
    vocab=256,
    loss_chunk=32,
)
