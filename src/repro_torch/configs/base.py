"""Model and algorithm configs (a copy of ``repro.configs.base``).

Frozen dataclasses with the reference's fields and defaults, so a config
built here compares field for field with its JAX counterpart.
``MoEConfig`` (mixtral-8x22b, deepseek-v2-236b), ``MambaConfig``
(jamba-1.5-large-398b) and ``XLSTMConfig`` (xlstm-350m) are copied too.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts block config (GShard-style capacity dispatch)."""
    n_experts: int
    top_k: int
    n_shared: int = 0           # always-on shared experts (DeepSeek-V2)
    d_expert: int = 0           # expert FFN hidden size (0 -> use model d_ff)
    capacity_factor: float = 1.25
    group_size: int = 0         # dispatch group size in tokens (0 -> auto)


@dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0            # 0 -> ceil(d_model / 16)
    chunk: int = 64             # the reference's scan block; the port's
                                # selective-scan kernel runs whole sequences


@dataclass(frozen=True)
class XLSTMConfig:
    n_heads: int = 4
    chunk: int = 64             # mLSTM chunkwise-parallel block length
    proj_factor: float = 2.0    # mLSTM up-projection factor
    slstm_proj_factor: float = 1.3334


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
    moe: Optional[MoEConfig] = None
    moe_every: int = 1          # layer i uses MoE iff i % moe_every == moe_offset
    moe_offset: int = 0

    # --- block pattern ---
    block_pattern: Tuple[str, ...] = ("attn",)
    mamba: Optional[MambaConfig] = None
    xlstm: Optional[XLSTMConfig] = None

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

    def layer_uses_moe(self, pos_in_unit: int) -> bool:
        if self.moe is None:
            return False
        return pos_in_unit % self.moe_every == self.moe_offset

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
    The semi-async fields (``quorum``, ``staleness_discount``,
    ``timeline``, ``k_max``, ``ring_capacity``) and the fault fields
    (``faults``, a ``core.faults.FaultPlan``; ``quorum_timeout``;
    ``max_retries``) are read by the engine's mode='async'
    (``core/events.py``)."""
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
    # semi-async execution (engine mode='async', core/events.py): commit a
    # server version once `quorum` contributions arrived (0 = wait for all
    # pending, the synchronous barrier); a contribution applied s commits
    # after its fetch weighs staleness_discount**s (1.0 = no discount)
    quorum: int = 0
    staleness_discount: float = 1.0
    # timeline backend for mode='async': 'dense' precompiles (V, M) rows;
    # 'sparse' streams (V, k_max) commit batches over an arrival-slot ring
    # store of ring_capacity slots (0 = auto for both knobs,
    # events.resolve_store_geometry)
    timeline: str = "dense"
    k_max: int = 0
    ring_capacity: int = 0
    # fault injection and graceful degradation (core/faults.py): None (or
    # FaultPlan.none()) keeps the event stream bit-exact with the clean
    # engine; quorum_timeout > 0 lets a commit go ahead with whatever
    # arrived by t + quorum_timeout; a lost delivery is resent up to
    # max_retries times before the contribution is dropped
    faults: Optional[Any] = None
    quorum_timeout: float = 0.0
    max_retries: int = 3
