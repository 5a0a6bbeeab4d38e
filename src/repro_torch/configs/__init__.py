from repro_torch.configs.base import (MambaConfig, ModelConfig, MoEConfig,
                                     SFLConfig, XLSTMConfig)
from repro_torch.configs.registry import card_smoke_config, get_config
