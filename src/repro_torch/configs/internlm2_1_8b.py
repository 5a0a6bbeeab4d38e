"""internlm2-1.8b [dense] — GQA. [arXiv:2403.17297; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-1.8b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=92544,
    max_seq_len=32_768,
    sub_quadratic=False,
    default_cut_units=2,
)

SMOKE = CONFIG.replace(
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=256, max_seq_len=256,
)
