"""olmo-1b [dense] — non-parametric LayerNorm, tied embeddings, MHA.
[arXiv:2402.00838; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=50304,
    norm_type="nonparam_ln",
    tie_embeddings=True,
    max_seq_len=4096,
    sub_quadratic=False,
    default_cut_units=2,
)

SMOKE = CONFIG.replace(
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=256, max_seq_len=256,
)
