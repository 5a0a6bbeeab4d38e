"""Architecture registry for the port: ``--arch <id>`` lookup. The dense
attention decoders (LayerNorm and RMSNorm), the GQA mixture of experts
(mixtral-8x22b), the MLA mixture of experts with shared experts
(deepseek-v2-236b), the Mamba hybrid (jamba-1.5-large-398b) and xLSTM
(xlstm-350m) are ported; the other families are queued in ROADMAP.md."""
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
    "deepseek-v2-236b": "repro_torch.configs.deepseek_v2_236b",
    "jamba-1.5-large-398b": "repro_torch.configs.jamba_1_5_large_398b",
    "xlstm-350m": "repro_torch.configs.xlstm_350m",
}


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(
            f"arch {name!r} is not ported to repro_torch yet (ported: "
            f"{sorted(_MODULES)}); see ROADMAP.md, queue 1, for the order "
            f"in which the other families follow")
    mod = importlib.import_module(_MODULES[name])
    return mod.SMOKE if smoke else mod.CONFIG


def card_smoke_config(name: str, n_kv_heads: int = 1) -> ModelConfig:
    """``name``'s SMOKE config in f32, widened to head dims the flash
    kernel takes (the SMOKE configs' are narrower): d_model 128, 2 query
    heads of 64 and ``n_kv_heads`` kv heads; an MLA config to the kernel's
    (192, 128) pair instead (nope 128, rope 64, v 128, 2 heads), its
    latent ranks and MoE (capacity factor included) as in SMOKE; a Mamba
    config's d_inner follows d_model (256 at expand 2) and its d_state
    stays SMOKE's; an xLSTM config keeps SMOKE's ``xlstm`` (4 heads, chunk
    16), so d_model 128 gives the mLSTM d_up 256 (head dim 64) and the
    sLSTM head dim 32 (the sLSTM kernel's one-block case). The small
    card-vs-CPU checks run on it."""
    cfg = get_config(name, smoke=True).replace(
        d_model=128, n_heads=2, n_kv_heads=n_kv_heads, dtype="float32")
    if cfg.attn_impl == "mla":
        cfg = cfg.replace(n_kv_heads=2, qk_nope_dim=128, qk_rope_dim=64,
                          v_head_dim=128, d_head=192)
    return cfg
