"""StableLM-3B [hf:stabilityai family]: 32L d2560 32H full MHA (kv=32),
d_ff 6912, vocab 50304."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b",
    family="dense",
    n_layers=32,
    d_model=2560,
    n_heads=32,
    n_kv=32,
    d_ff=6912,
    vocab=50304,
    rope_theta=10000.0,
)

SMOKE = ModelConfig(
    name="stablelm-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv=4,
    d_ff=128,
    vocab=256,
    loss_chunk=32,
)
