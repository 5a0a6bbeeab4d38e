"""paper-opt-1.3b — the paper's own LLM setting (OPT-1.3B, §5): 24
transformer blocks, LayerNorm, GELU MLP."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="paper-opt-1.3b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=50272,
    norm_type="layernorm",
    mlp_type="gelu",
    max_seq_len=2048,
    sub_quadratic=False,
    default_cut_units=2,
)

SMOKE = CONFIG.replace(
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=256, max_seq_len=256,
)
