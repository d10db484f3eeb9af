"""OLMoE-1B-7B [arXiv:2409.02060; hf]: 16L d2048 16H (kv=16) MoE 64e top-8,
expert FF 1024, vocab 50304."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv=16,
    d_ff=1024,            # unused for routed path; experts use d_expert
    vocab=50304,
    n_experts=64,
    top_k=8,
    d_expert=1024,
    rope_theta=10000.0,
)

SMOKE = ModelConfig(
    name="olmoe-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv=4,
    d_ff=128,
    vocab=256,
    n_experts=8,
    top_k=2,
    d_expert=128,
    loss_chunk=32,
)
