"""mistral-nemo-12b [dense] — GQA, 128k context, head_dim=128 (decoupled
from d_model/n_heads). [hf:mistralai/Mistral-Nemo-Base-2407; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mistral-nemo-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14336,
    vocab_size=131072,
    rope_theta=1_000_000.0,
    max_seq_len=131_072,
    sub_quadratic=False,
    default_cut_units=4,
)

SMOKE = CONFIG.replace(
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_head=16, d_ff=128,
    vocab_size=256, max_seq_len=256,
)
