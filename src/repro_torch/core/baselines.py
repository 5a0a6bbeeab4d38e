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

The first-order baselines (``fedavg_round``, ``fedlora_round``) need a
differentiable model path and are not ported (ROADMAP.md, queue 1,
item 4).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, SFLConfig
from repro_torch.core import prng, zo
from repro_torch.core.splitfed import RoundMetrics, mu_splitfed_round
from repro_torch.models import (client_forward, merge_params, server_forward,
                                split_params)
from repro_torch.utils import tree

Params = Any


def vanilla_splitfed_round(cfg: ModelConfig, sfl: SFLConfig, params: Params,
                           batches, active_mask, round_key, **kw):
    """SplitFed with ZO updates and one server step a round."""
    return mu_splitfed_round(cfg, dataclasses.replace(sfl, tau=1), params,
                             batches, active_mask, round_key, **kw)


class GasState(NamedTuple):
    h_buffer: Any       # {"h": (M, B, S, D)} last-used unperturbed activations
    label_buffer: Any   # {"tokens", "labels": (M, B, S)} their batches


def _stack(rows):
    return {k: torch.stack([r[k] for r in rows]) for k in rows[0]}


@torch.inference_mode()
def gas_init_state(cfg: ModelConfig, sfl: SFLConfig, params: Params,
                   batches) -> GasState:
    """Fill the buffer with an initial sweep (round 0 everyone is fresh)."""
    xc, _ = split_params(cfg, params, sfl.cut_units)
    h = _stack([client_forward(cfg, xc, {k: v[m] for k, v in batches.items()})
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
