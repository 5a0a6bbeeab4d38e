"""Architecture registry for the port: ``--arch <id>`` lookup. The dense
attention decoders (LayerNorm and RMSNorm) and the GQA mixture of experts
(mixtral-8x22b) are ported; the other families are queued in
ROADMAP.md."""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import ModelConfig

_MODULES: Dict[str, str] = {
    "olmo-1b": "repro_torch.configs.olmo_1b",
    "paper-opt-1.3b": "repro_torch.configs.paper_opt_1_3b",
    "qwen3-14b": "repro_torch.configs.qwen3_14b",
    "internlm2-1.8b": "repro_torch.configs.internlm2_1_8b",
    "mistral-nemo-12b": "repro_torch.configs.mistral_nemo_12b",
    "mixtral-8x22b": "repro_torch.configs.mixtral_8x22b",
}


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(
            f"arch {name!r} is not ported to repro_torch yet (ported: "
            f"{sorted(_MODULES)}); see ROADMAP.md, queue 1, for the order "
            f"in which the other families follow")
    mod = importlib.import_module(_MODULES[name])
    return mod.SMOKE if smoke else mod.CONFIG
