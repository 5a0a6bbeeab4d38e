"""mixtral-8x22b [moe] — 8 experts top-2, sliding-window attention.
[arXiv:2401.04088; hf]"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=32768,
    sliding_window=4096,
    moe=MoEConfig(n_experts=8, top_k=2),
    max_seq_len=524_288,
    sub_quadratic=True,          # SWA -> O(S*w) -> long_500k eligible
    default_cut_units=2,
)

SMOKE = CONFIG.replace(
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=256, sliding_window=32, moe=MoEConfig(n_experts=4, top_k=2),
    max_seq_len=256,
)
