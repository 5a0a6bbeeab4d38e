from repro_torch.configs.base import ModelConfig, MoEConfig, SFLConfig
from repro_torch.configs.registry import card_smoke_config, get_config
