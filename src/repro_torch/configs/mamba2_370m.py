"""Mamba2-370M [arXiv:2405.21060]: 48L d1024 attention-free SSD,
ssm_state 128, expand 2, headdim 64, vocab 50280."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=0,
    n_kv=0,
    d_ff=0,
    vocab=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_conv=4,
    ssm_chunk=256,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="mamba2-smoke",
    family="ssm",
    n_layers=2,
    d_model=64,
    n_heads=0,
    n_kv=0,
    d_ff=0,
    vocab=256,
    ssm_state=16,
    ssm_expand=2,
    ssm_headdim=16,
    ssm_conv=4,
    ssm_chunk=16,
    tie_embeddings=True,
    loss_chunk=32,
)
