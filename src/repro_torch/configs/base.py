"""Model and algorithm configs (a copy of ``repro.configs.base``).

Frozen dataclasses with the reference's fields and defaults, so a config
built here compares field for field with its JAX counterpart. The
sub-configs of other families (MoE, Mamba, xLSTM) are not ported yet;
their fields stay, typed loosely, and are None for the archs this package
knows.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    """A single architecture. ``block_pattern`` is the repeating unit of
    block types; ``n_layers`` must be a multiple of its length."""
    name: str
    family: str                 # dense|moe|hybrid|vlm|audio|ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0             # 0 -> d_model // n_heads

    # --- attention ---
    attn_impl: str = "gqa"      # gqa|mla
    qk_norm: bool = False
    sliding_window: int = 0     # 0 -> full attention
    rope_theta: float = 10_000.0
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_rope_dim: int = 64
    qk_nope_dim: int = 128
    v_head_dim: int = 128

    # --- norms / mlp ---
    norm_type: str = "rmsnorm"  # rmsnorm|layernorm|nonparam_ln
    mlp_type: str = "swiglu"    # swiglu|gelu
    moe: Optional[Any] = None
    moe_every: int = 1
    moe_offset: int = 0

    # --- block pattern ---
    block_pattern: Tuple[str, ...] = ("attn",)
    mamba: Optional[Any] = None
    xlstm: Optional[Any] = None

    # --- encoder/decoder ---
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    n_audio_frames: int = 0

    # --- vlm ---
    n_image_tokens: int = 0

    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    max_seq_len: int = 131_072

    # --- paper (SFL) defaults for this arch ---
    default_cut_units: int = 1  # client-side depth in repeating units
    sub_quadratic: bool = False

    def __post_init__(self):
        if self.d_head == 0:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)
        if self.n_layers % len(self.block_pattern):
            raise ValueError(
                f"{self.name}: n_layers={self.n_layers} not a multiple of "
                f"pattern len {len(self.block_pattern)}")

    @property
    def n_units(self) -> int:
        return self.n_layers // len(self.block_pattern)

    def replace(self, **kw) -> "ModelConfig":
        # d_head derives from d_model/n_heads; reset it when they change
        # unless it is given explicitly.
        if ("d_model" in kw or "n_heads" in kw) and "d_head" not in kw:
            kw["d_head"] = 0
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class SFLConfig:
    """MU-SplitFed algorithm config (the paper's technique): the fields of
    ``repro.configs.base.SFLConfig`` that the synchronous round and the
    synchronous engine read, with the same defaults. The client fleet is
    ``population`` (a ``repro_torch.core.population.ClientPopulation``);
    ``straggler_rate`` / ``participation`` are the reference's deprecated
    single-cohort shorthand, resolved by ``ClientPopulation.resolve(sfl)``.
    The semi-async and fault fields come back with the slice that reads
    them (ROADMAP.md, queue 1, item 5)."""
    n_clients: int = 16         # M
    tau: int = 2                # unbalanced server update steps per round
    n_perturbations: int = 1    # P (SPSA averaging)
    cut_units: int = 1          # L_c in repeating units
    lr_server: float = 1e-2     # eta_s
    lr_client: float = 5e-3     # eta_c
    lr_global: float = 0.3      # eta_g
    zo_eps: float = 5e-3        # lambda (smoothing)
    participation: float = 1.0  # DEPRECATED shorthand (see population)
    perturbation_dist: str = "gaussian"  # gaussian|sphere|counter
    seed: int = 0               # FedLoRA's adapter init key
    # straggler simulation
    straggler_rate: float = 0.0     # DEPRECATED shorthand (see population)
    deadline: float = 0.0           # drop clients beyond deadline (0 = off)
    population: Optional[Any] = None  # None -> one cohort from the shorthand
