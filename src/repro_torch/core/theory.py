"""Theory calculators (counterpart of ``repro.core.theory``, copied
whole): convergence bounds (Thm 4.1 / 4.3, Cor 4.2 / 4.4), the Table-2
communication-complexity comparison, and the cut-layer planner
(d_c = √(d/τ)) that couples the split point to the unbalanced-update ratio.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

from repro_torch.configs.base import ModelConfig


# ---------------------------------------------------------------------------
# Thm 4.1 (MU-Split, M=1) — Eq. (8)
# ---------------------------------------------------------------------------

def mu_split_bound(F0: float, L: float, T: int, tau: int, d_c: int, d_s: int,
                   sigma_c: float, sigma_s: float, lam: float,
                   eta: float | None = None) -> Dict[str, float]:
    """Evaluate the five terms of Eq. (8). Returns each term + total."""
    if eta is None:
        eta = min(1.0 / (64 * L * (tau + 2 * d_s)), 1.0 / (16 * L * tau * d_c))
    t1 = 4 * F0 / (eta * tau * T)
    t2 = 16 * eta * L * (eta * tau * L + 1) * d_s * sigma_s ** 2
    t3 = 8 * eta * tau * L * d_c * sigma_c ** 2
    t4 = 4 * L ** 2 * (eta ** 2 * tau ** 2 * L ** 2 + 0.25) * lam ** 2 * d_s ** 3
    t5 = L ** 2 * lam ** 2 * d_c ** 3
    return {"opt": t1, "var_s": t2, "var_c": t3, "zo_s": t4, "zo_c": t5,
            "total": t1 + t2 + t3 + t4 + t5, "eta": eta}


def mu_split_rate(F0: float, L: float, T: int, tau: int, d: int,
                  sigma_c: float, sigma_s: float) -> float:
    """Cor 4.2 — the O(√(d/(τT))) rate with the optimal cut d_c = √(d/τ)."""
    sd, st = math.sqrt(d), math.sqrt(tau * T)
    return (4 * sd * F0 / st + 48 * L * sd * sigma_s ** 2 / st
            + 9 * sd / st + 8 * L * sigma_c ** 2 / math.sqrt(T))


# ---------------------------------------------------------------------------
# Thm 4.3 (MU-SplitFed, M clients) — Eq. (10) / Cor 4.4 — Eq. (11)
# ---------------------------------------------------------------------------

def mu_splitfed_bound(F0: float, L: float, T: int, tau: int, M: int,
                      d_c: int, d_s: int, sigma_c: float, sigma_s: float,
                      eps_het: float, lam: float, eta: float | None = None,
                      eta_g: float | None = None) -> Dict[str, float]:
    """Evaluate the seven terms of Eq. (10)."""
    if eta is None:
        eta = min(1.0 / (120 * L * tau * (1 + 2 * d_s / tau)),
                  M / (12 * tau * L * d_c))
    if eta_g is None:
        eta_g = math.sqrt(tau * M)
    t1 = 4 * F0 / (T * eta_g * eta * tau)
    t2 = 16 * eta * (2 * eta * tau * L + eta_g / M) * L * d_s * sigma_s ** 2
    t3 = 4 * eta_g * eta * tau * L * d_c * sigma_c ** 2 / M
    t4 = 24 * eta * (4 * eta * tau * L + eta_g / M) * L * (tau + 2 * d_s) * eps_het ** 2
    t5 = 12 * eta_g * eta * tau * L * d_c * eps_het ** 2 / M
    t6 = (1 / tau + 8 * eta ** 2 * tau * L ** 2
          + 2 * eta_g * eta / M) * tau * L ** 2 * lam ** 2 * d_s ** 3
    t7 = L ** 2 * lam ** 2 * d_c ** 3
    return {"opt": t1, "var_s": t2, "var_c": t3, "het_s": t4, "het_c": t5,
            "zo_s": t6, "zo_c": t7, "total": sum((t1, t2, t3, t4, t5, t6, t7)),
            "eta": eta, "eta_g": eta_g}


def mu_splitfed_rate(F0: float, L: float, T: int, tau: int, M: int, d: int,
                     sigma_c: float, sigma_s: float, eps_het: float) -> float:
    """Cor 4.4 — the O(√(d/(τTM))) rate."""
    sd = math.sqrt(d)
    stm = math.sqrt(tau * T * M)
    return (4 * L * sd * F0 / stm
            + 8 * sd * (3 * eps_het ** 2 + 2 * sigma_s ** 2) / stm
            + 32 * sd * (3 * eps_het ** 2 + sigma_s ** 2) / (tau * T)
            + (12 * eps_het ** 2 + 4 * sigma_c ** 2) / math.sqrt(T * M)
            + 6 * sd / (tau * T))


# ---------------------------------------------------------------------------
# Table 2: communication complexity to reach epsilon accuracy
# ---------------------------------------------------------------------------

def comm_complexity(method: str, d: int, tau: int, M: int, K: int,
                    eps: float) -> float:
    """Split-Server communication cost (number of scalar rounds, up to
    constants) to reach an ε-approximate stationary point."""
    e2 = eps ** 2
    table = {
        "sfl_v1": K / e2,
        "sfl_v2": K / (M * e2),
        "mu_splitfed_tau1": d / (M * e2),
        "mu_splitfed": d / (tau * M * e2),
        "mu_splitfed_tau_to_d": 1.0 / (M * e2),
    }
    return table[method]


def rounds_to_eps(d: int, tau: int, M: int, eps: float) -> float:
    """T needed so that √(d/(τTM)) <= ε  =>  T = d/(τ M ε²)."""
    return d / (tau * M * eps ** 2)


# ---------------------------------------------------------------------------
# cut-layer planner (Cor 4.2/4.4: d_c = √(d/τ))
# ---------------------------------------------------------------------------

def optimal_dc(d: int, tau: int) -> float:
    return math.sqrt(d / tau)


def optimal_tau_for_cut(d: int, d_c: int, tau_max: int = 64) -> int:
    """Invert d_c = √(d/τ): τ* = d/d_c² (clipped to [1, tau_max])."""
    tau = d / max(d_c, 1) ** 2
    return int(min(max(round(tau), 1), tau_max))


def plan_cut(cfg: ModelConfig, tau: int) -> Tuple[int, Dict[int, float]]:
    """Choose the unit-boundary cut whose d_c best matches √(d/τ).

    Returns (cut_units, {cut: |log(d_c/target)|}). Uses exact per-cut
    parameter counts from the model's split machinery.
    """
    from repro_torch.models import split_dims
    n_cuts = (cfg.n_encoder_layers if cfg.is_encoder_decoder else cfg.n_units)
    scores: Dict[int, float] = {}
    best, best_score = 1, float("inf")
    for cut in range(1, n_cuts + 1):
        d_c, d_s = split_dims(cfg, cut)
        d = d_c + d_s
        target = optimal_dc(d, tau)
        score = abs(math.log(max(d_c, 1) / target))
        scores[cut] = score
        if score < best_score:
            best, best_score = cut, score
    return best, scores
