"""Phi-3-vision 4.2B [hf:microsoft/Phi-3-vision-128k-instruct]: phi3-mini
backbone 32L d3072 32H (kv=32) d_ff 8192, vocab 32064 + CLIP frontend (STUB:
input_specs provides precomputed patch embeddings; 576 image tokens)."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv=32,
    d_ff=8192,
    vocab=32064,
    n_img_tokens=576,
    rope_theta=10000.0,
)

SMOKE = ModelConfig(
    name="phi3v-smoke",
    family="vlm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv=4,
    d_ff=128,
    vocab=256,
    n_img_tokens=16,
    loss_chunk=32,
)
