"""Whisper-tiny [arXiv:2212.04356]: enc-dec, 4L encoder + 4L decoder, d384,
6H, d_ff 1536, vocab 51865; conv frontend STUB (input_specs provides 1500
precomputed frame embeddings).  Decoder max target length 448 — decode-shape
KV caches clamp to it (noted per brief)."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="encdec",
    n_layers=4,
    n_enc_layers=4,
    d_model=384,
    n_heads=6,
    n_kv=6,
    d_ff=1536,
    vocab=51865,
    qkv_bias=True,
    n_audio_frames=1500,
    max_target_len=448,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="whisper-smoke",
    family="encdec",
    n_layers=2,
    n_enc_layers=2,
    d_model=64,
    n_heads=4,
    n_kv=4,
    d_ff=128,
    vocab=256,
    qkv_bias=True,
    n_audio_frames=32,
    max_target_len=32,
    tie_embeddings=True,
    loss_chunk=16,
)
