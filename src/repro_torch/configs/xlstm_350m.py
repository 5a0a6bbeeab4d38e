"""xlstm-350m [ssm] — mLSTM (matrix memory) + sLSTM (scalar memory) blocks,
no separate FFN (d_ff=0; blocks are self-contained). [arXiv:2405.04517;
unverified]"""
from repro_torch.configs.base import ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    block_pattern=("mlstm", "mlstm", "mlstm", "slstm"),
    xlstm=XLSTMConfig(n_heads=4, chunk=64),
    max_seq_len=524_288,
    sub_quadratic=True,          # recurrent -> long_500k eligible
    default_cut_units=1,
)

SMOKE = CONFIG.replace(
    n_layers=8, d_model=64, n_heads=4, n_kv_heads=4,
    vocab_size=256, xlstm=XLSTMConfig(n_heads=4, chunk=16),
    max_seq_len=256,
)
