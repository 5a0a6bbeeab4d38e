"""jamba-1.5-large-398b [hybrid] — Mamba+attn 1:7 interleave, MoE every
other layer (16 experts, top-2). [arXiv:2403.19887; hf]"""
from repro_torch.configs.base import MambaConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    moe=MoEConfig(n_experts=16, top_k=2),
    moe_every=2,
    moe_offset=1,
    block_pattern=("mamba", "mamba", "mamba", "attn",
                   "mamba", "mamba", "mamba", "mamba"),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    max_seq_len=524_288,
    sub_quadratic=True,          # 1:7 SSM hybrid -> long_500k eligible
    default_cut_units=1,
)

SMOKE = CONFIG.replace(
    n_layers=16, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=256, moe=MoEConfig(n_experts=4, top_k=2),
    mamba=MambaConfig(d_state=4, d_conv=4, expand=2, chunk=16),
    max_seq_len=256,
)
