from repro_torch.configs.base import ModelConfig, MoEConfig, SFLConfig
from repro_torch.configs.registry import get_config
