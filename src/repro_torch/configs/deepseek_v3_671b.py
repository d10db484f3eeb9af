"""DeepSeek-V3 671B [arXiv:2412.19437; hf]: 61L d7168, MLA (q_lora 1536,
kv_lora 512, nope 128, rope 64, v 128) 128 heads, MoE 1 shared + 256 routed
top-8 (expert FF 2048), MTP, vocab 129280."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv=128,
    d_ff=2048,
    vocab=129280,
    n_experts=256,
    top_k=8,
    d_expert=2048,
    n_shared_experts=1,
    mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    mtp=True,
    rope_theta=10000.0,
    remat="full",          # 61 x 7168: remat everything by default
)

SMOKE = ModelConfig(
    name="deepseek-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv=4,
    d_ff=96,
    vocab=256,
    n_experts=8,
    top_k=2,
    d_expert=96,
    n_shared_experts=1,
    mla=True,
    q_lora_rank=32,
    kv_lora_rank=16,
    qk_nope_dim=16,
    qk_rope_dim=8,
    v_head_dim=16,
    mtp=True,
    loss_chunk=32,
)
