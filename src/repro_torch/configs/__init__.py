from repro_torch.configs.base import ModelConfig, SFLConfig
from repro_torch.configs.registry import get_config
