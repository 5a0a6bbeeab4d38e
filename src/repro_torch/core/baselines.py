"""The zeroth-order baselines the paper compares against (§5;
counterpart of ``repro.core.baselines``):

  vanilla_splitfed_round : SplitFed with ZO but no unbalanced updates,
                           exactly MU-SplitFed at τ=1 (the shared code path
                           is itself a check).
  gas_round              : GAS-like asynchronous SFL: the server trains a
                           slow client's replica from its *stale buffered
                           activation* instead of waiting. Staleness enters
                           as the fresh/stale mask row of the schedule; the
                           activation buffer is carried across rounds as
                           device tensors (``GasState``).
  fedavg_round           : first-order FedAvg (full model on every client,
                           E local SGD/momentum/AdamW steps), the memory
                           and convergence baseline of Fig. 4 / §5.
  fedlora_round          : FedAvg over LoRA adapters (only (A, B) train
                           and ship).

The first-order rounds take gradients with ``torch.autograd.grad`` of
``loss_fn``, outside ``inference_mode``: attention and RMSNorm go through
their kernels' autograd Functions. As in the reference every one of the M
clients trains (the reference vmaps all of them); the mask only weights
the aggregation, w = mask / max(Σmask, 1), and the new global tree is
g + η_g·Σ w_m·(p_m - g) in f32. The reference stacks the M trained copies;
the port trains the clients one after another and keeps an f32 running
sum, so its peak memory is one client copy plus that sum. A model with
Mamba blocks (jamba) differentiates its selective scan through the scan's
backward kernel, and one with xLSTM blocks (xlstm-350m) its sLSTM
recurrence through the sLSTM's backward kernel (the mLSTM's chunks are
PyTorch's autograd).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, SFLConfig
from repro_torch.core import prng, zo
from repro_torch.core.splitfed import RoundMetrics, mu_splitfed_round
from repro_torch.models import (client_forward, loss_fn, merge_params,
                                server_forward, split_params)
from repro_torch.optim import make_optimizer, sgd_update
from repro_torch.optim.lora import apply_lora
from repro_torch.utils import tree

Params = Any


def vanilla_splitfed_round(cfg: ModelConfig, sfl: SFLConfig, params: Params,
                           batches, active_mask, round_key, **kw):
    """SplitFed with ZO updates and one server step a round."""
    return mu_splitfed_round(cfg, dataclasses.replace(sfl, tau=1), params,
                             batches, active_mask, round_key, **kw)


class GasState(NamedTuple):
    h_buffer: Any       # {"h": (M, B, S, D), "aux": (M,)} last-used
                        # unperturbed client forwards (aux: the client's
                        # MoE aux loss, 0.0 on a dense model)
    label_buffer: Any   # {"tokens", "labels": (M, B, S)} their batches


def _stack(rows):
    return {k: torch.stack([r[k] for r in rows]) for k in rows[0]}


@torch.inference_mode()
def gas_init_state(cfg: ModelConfig, sfl: SFLConfig, params: Params,
                   batches) -> GasState:
    """Fill the buffer with an initial sweep (round 0 everyone is fresh)."""
    xc, _ = split_params(cfg, params, sfl.cut_units)
    h = _stack([client_forward(cfg, xc,
                               {k: v[m] for k, v in batches.items()})
                for m in range(sfl.n_clients)])
    return GasState(h_buffer=h, label_buffer=dict(batches))


def _gas_client(cfg: ModelConfig, sfl: SFLConfig, xc: Params, xs: Params,
                b_new, b_old, h_old, mkey, fresh: torch.Tensor, replay: str
                ) -> Dict[str, Any]:
    """One client of a GAS round. A stale client (fresh 0) still computes
    its new messages, as the reference does; the server trains its replica
    from the buffered activation and batch, and its client coefficient is
    multiplied by 0."""
    dist = sfl.perturbation_dist
    ukey = prng.fold_in(mkey, 0)
    skey = prng.fold_in(mkey, 1)
    is_fresh = fresh > 0
    h_new = client_forward(cfg, xc, b_new)
    h = {k: torch.where(is_fresh, h_new[k], h_old[k]) for k in h_new}
    b_used = {k: torch.where(is_fresh, b_new[k], b_old[k]) for k in b_new}
    hp = client_forward(cfg, zo.perturb(xc, ukey, +sfl.zo_eps, dist), b_new)
    hm = client_forward(cfg, zo.perturb(xc, ukey, -sfl.zo_eps, dist), b_new)
    loss0 = server_forward(cfg, xs, h, b_used)

    def loss_of(sp):
        return server_forward(cfg, sp, h, b_used)

    sp_new, delta, (skeys, scoeffs) = zo.spsa_step(
        loss_of, xs, skey, sfl.zo_eps, sfl.lr_server, sfl.n_perturbations,
        dist, replay)
    delta_c = (server_forward(cfg, sp_new, hp, b_new)
               - server_forward(cfg, sp_new, hm, b_new)).to(torch.float32)
    ccoeff = fresh * sfl.lr_client * delta_c / (2.0 * sfl.zo_eps)
    return {"xs_final": sp_new, "h": h, "b": b_used, "ukey": ukey,
            "ccoeff": ccoeff, "loss0": loss0, "delta": delta,
            "skeys": skeys, "scoeffs": scoeffs}


@torch.inference_mode()
def gas_round(cfg: ModelConfig, sfl: SFLConfig, params: Params,
              state: GasState, batches, fresh_mask: torch.Tensor, round_key,
              *, aggregation: str = "dense", replay: str = "auto"
              ) -> Tuple[Params, GasState, RoundMetrics]:
    """fresh_mask (M,) f32: 1 = the client delivered this round; 0 = a
    straggler, whose server replica trains from the buffered activation.
    The server takes one SPSA step a client whatever τ is; aggregation
    weights are uniform (1/M), not mask-normalised. Only fresh clients'
    client-side records carry weight (they got δ_c in time).

    aggregation='seed_replay' replays each client's (P,) server records
    and its client record into the global halves (``zo.
    replay_weighted_records``) instead of averaging dense replicas.
    Returns (new_params, new_state, metrics)."""
    if aggregation not in ("dense", "seed_replay"):
        raise ValueError(f"gas_round: unsupported aggregation "
                         f"{aggregation!r} (want 'dense' or 'seed_replay')")
    M = sfl.n_clients
    xc, xs = split_params(cfg, params, sfl.cut_units)
    fresh = fresh_mask.to(torch.float32)
    w = torch.full((M,), 1.0 / M, dtype=torch.float32, device=fresh.device)
    acc = (tree.tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                               device=g.device), xs)
           if aggregation == "dense" else None)
    outs = []
    for m in range(M):
        o = _gas_client(cfg, sfl, xc, xs,
                        {k: v[m] for k, v in batches.items()},
                        {k: v[m] for k, v in state.label_buffer.items()},
                        {k: v[m] for k, v in state.h_buffer.items()},
                        prng.fold_in(round_key, m), fresh[m], replay)
        xs_m = o.pop("xs_final")
        if acc is not None:
            acc = tree.tree_map(
                lambda a, f, g: a + w[m] * (f - g).to(torch.float32),
                acc, xs_m, xs)
        outs.append(o)

    if acc is not None:
        xs_new = tree.tree_map(
            lambda g, a: (g + sfl.lr_global * a).to(g.dtype), xs, acc)
    else:   # the (M, P) server records, weighted η_g·w_m
        xs_new = zo.replay_weighted_records(
            xs, np.stack([o["skeys"] for o in outs]),
            torch.stack([o["scoeffs"] for o in outs]), sfl.lr_global * w,
            sfl.perturbation_dist, replay)
    ccoeff = torch.stack([o["ccoeff"] for o in outs])
    xc_new = zo.replay_weighted_records(
        xc, np.stack([o["ukey"] for o in outs]), ccoeff, sfl.lr_global * w,
        sfl.perturbation_dist, replay)
    new_state = GasState(h_buffer=_stack([o["h"] for o in outs]),
                         label_buffer=_stack([o["b"] for o in outs]))
    metrics = RoundMetrics(loss=torch.stack([o["loss0"] for o in outs]),
                           server_deltas=torch.stack(
                               [o["delta"] for o in outs])[:, None],
                           client_delta=ccoeff)
    return merge_params(cfg, xc_new, xs_new), new_state, metrics


# ---------------------------------------------------------------------------
# first-order baselines
# ---------------------------------------------------------------------------

def _grads(loss_of, params: Params) -> Params:
    """d loss_of(params) / d params for every leaf (zeros for a leaf the
    loss does not reach), with autograd on whatever mode the caller is in."""
    leaves, spec = tree.flatten(params)
    with torch.inference_mode(False), torch.enable_grad():
        xs = [a.detach().requires_grad_(True) for a in leaves]
        loss = loss_of(tree.unflatten(spec, xs))
        gs = torch.autograd.grad(loss, xs, allow_unused=True)
    return tree.unflatten(spec, [torch.zeros_like(x) if g is None else g
                                 for x, g in zip(xs, gs)])


def _client_batch(batches, m: int, e=None):
    return {k: (v[m] if e is None else v[m, e]) for k, v in batches.items()}


def _fedavg_aggregate(glob: Params, train, active_mask: torch.Tensor,
                      eta_g: float) -> Params:
    """g + η_g·Σ_m w_m·(p_m - g), w = mask / max(Σmask, 1), in f32; each
    difference is taken in the leaf's type, as the reference takes it.
    ``train(m)`` returns client m's tree; the M trees are made one at a
    time, each freed before the next is trained (an ``enumerate`` over a
    generator would keep the last one alive while the next trains)."""
    w = (active_mask / active_mask.sum().clamp(min=1.0)).to(torch.float32)
    g_leaves, spec = tree.flatten(glob)
    acc = [torch.zeros(a.shape, dtype=torch.float32, device=a.device)
           for a in g_leaves]
    for m in range(active_mask.shape[0]):
        p_m = train(m)
        with torch.no_grad():
            for a, pm, g in zip(acc, tree.leaves(p_m), g_leaves):
                a.add_((pm - g).to(torch.float32).mul_(w[m]))
        del p_m, pm
    with torch.no_grad():
        return tree.unflatten(spec, [(g + eta_g * a).to(g.dtype)
                                     for g, a in zip(g_leaves, acc)])


def fedavg_round(cfg: ModelConfig, params: Params, batches, active_mask,
                 lr: float, local_steps: int = 1, optimizer: str = "sgd",
                 eta_g: float = 1.0) -> Params:
    """One FedAvg round: E local first-order steps per client from the
    global parameters and a fresh optimizer state, then the FedAvg
    aggregate. Local batches: leaves (M, E, b, S) when local_steps > 1,
    else (M, b, S)."""
    init_opt, update = make_optimizer(optimizer)

    def local(m):
        p, s = params, init_opt(params)
        for e in range(local_steps):
            b = _client_batch(batches, m, e if local_steps > 1 else None)
            g = _grads(lambda q: loss_fn(cfg, q, b), p)
            with torch.no_grad():
                p, s = update(p, g, s, lr)
            del g
        return p

    return _fedavg_aggregate(params, local, active_mask, eta_g)


def fedlora_round(cfg: ModelConfig, params: Params, lora, batches,
                  active_mask, lr: float, alpha: float = 16.0,
                  eta_g: float = 1.0):
    """Clients take one SGD step on the LoRA adapters only (the base
    parameters never move); only (A, B) are aggregated. Returns the new
    adapter tree."""

    def local(m):
        b = _client_batch(batches, m)
        g = _grads(lambda lo: loss_fn(cfg, apply_lora(params, lo, alpha), b),
                   lora)
        with torch.no_grad():
            return sgd_update(lora, g, lr)

    return _fedavg_aggregate(lora, local, active_mask, eta_g)
