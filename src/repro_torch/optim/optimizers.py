"""First-order optimizers for the FedAvg / FedLoRA baselines (counterpart
of ``repro.optim.optimizers``).

Functional and tree-generic over nested dicts of tensors: an update takes
(params, grads, state, lr) and returns new tensors, leaving its inputs as
they are. Moments are f32 and each update is cast back to the parameter's
type, as in the reference. Zeroth-order training keeps no optimizer state
(its memory story, ``core/zo.py``).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.utils import tree

Params = Any
F32 = torch.float32


class OptState(NamedTuple):
    step: torch.Tensor  # 0-d int32 on the parameters' device
    mu: Any             # first moment (or momentum buffer); None for SGD
    nu: Any             # second moment; None unless adam


def _step0(params: Params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32,
                       device=tree.leaves(params)[0].device)


def _zeros_f32(params: Params) -> Params:
    return tree.tree_map(lambda p: torch.zeros(p.shape, dtype=F32,
                                               device=p.device), params)


# --- SGD -------------------------------------------------------------------

def sgd_update(params: Params, grads: Params, lr) -> Params:
    """p - lr·g in f32, cast to p's type. The f32 product is negated and
    p added in place, the same roundings as ``p - lr * g`` with one f32
    copy of the leaf instead of two."""
    def upd(p, g):
        return g.to(F32, copy=True).mul_(-lr).add_(p).to(p.dtype)
    return tree.tree_map(upd, params, grads)


# --- SGD + momentum ----------------------------------------------------------

def momentum_init(params: Params) -> OptState:
    return OptState(_step0(params), _zeros_f32(params), None)


def momentum_update(params: Params, grads: Params, state: OptState, lr,
                    beta: float = 0.9) -> Tuple[Params, OptState]:
    mu = tree.tree_map(lambda m, g: beta * m + g.to(F32), state.mu, grads)
    new = tree.tree_map(lambda p, m: (p - lr * m).to(p.dtype), params, mu)
    return new, OptState(state.step + 1, mu, None)


# --- AdamW -------------------------------------------------------------------

def adamw_init(params: Params) -> OptState:
    return OptState(_step0(params), _zeros_f32(params), _zeros_f32(params))


def adamw_update(params: Params, grads: Params, state: OptState, lr,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0) -> Tuple[Params, OptState]:
    step = state.step + 1
    t = step.to(F32)
    mu = tree.tree_map(lambda m, g: b1 * m + (1 - b1) * g.to(F32),
                       state.mu, grads)
    nu = tree.tree_map(lambda v, g: b2 * v + (1 - b2) * g.to(F32).square(),
                       state.nu, grads)
    bc1 = 1 - torch.pow(torch.tensor(b1, dtype=F32, device=t.device), t)
    bc2 = 1 - torch.pow(torch.tensor(b2, dtype=F32, device=t.device), t)

    def upd(p, m, v):
        mhat = m / bc1
        vhat = v / bc2
        step_ = lr * (mhat / (torch.sqrt(vhat) + eps)
                      + weight_decay * p.to(F32))
        return (p - step_).to(p.dtype)
    return tree.tree_map(upd, params, mu, nu), OptState(step, mu, nu)


# --- factory -----------------------------------------------------------------

def make_optimizer(name: str):
    """(init_fn(params), update_fn(params, grads, state, lr) -> (params,
    state))."""
    if name == "sgd":
        return (lambda p: OptState(_step0(p), None, None),
                lambda p, g, s, lr: (sgd_update(p, g, lr),
                                     OptState(s.step + 1, None, None)))
    if name == "momentum":
        return momentum_init, momentum_update
    if name in ("adam", "adamw"):
        return adamw_init, adamw_update
    raise ValueError(name)
