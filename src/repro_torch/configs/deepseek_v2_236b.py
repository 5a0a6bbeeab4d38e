"""deepseek-v2-236b [moe] — MLA (kv_lora=512), 2 shared + 160 routed top-6
experts (d_expert=1536). [arXiv:2405.04434; hf]"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    d_ff=1536,
    vocab_size=102400,
    attn_impl="mla",
    kv_lora_rank=512,
    q_lora_rank=1536,
    qk_rope_dim=64,
    qk_nope_dim=128,
    v_head_dim=128,
    d_head=192,                  # qk_nope + qk_rope
    moe=MoEConfig(n_experts=160, top_k=6, n_shared=2, d_expert=1536),
    max_seq_len=131_072,
    sub_quadratic=False,         # MLA is still O(S^2) -> long_500k skipped
    default_cut_units=2,
)

SMOKE = CONFIG.replace(
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, d_ff=32,
    vocab_size=256, kv_lora_rank=16, q_lora_rank=24, qk_rope_dim=8,
    qk_nope_dim=16, v_head_dim=16, d_head=24,
    moe=MoEConfig(n_experts=8, top_k=2, n_shared=1, d_expert=32),
    max_seq_len=256,
)
