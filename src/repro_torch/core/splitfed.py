"""MU-SplitFed: the paper's unbalanced-update split federated round
(Algorithm 1) and the M=1 MU-Split case (counterpart of
``repro.core.splitfed``).

One global round:
  per client m:  three client forwards -> (h, h+, h-); τ server ZO steps
                 on the stale h; δ_c = F(x_s^τ, h+) − F(x_s^τ, h−) back to
                 the client, whose update is the record (u_m's key, η_c·δ_c/2λ)
  then:          dual aggregation (Eq. 7) with global lr η_g.

The clients run as a Python loop; that is the port's form of both of the
reference's ``client_mode``s, which compute the same function. A client
whose mask is 0 is still computed, and weighted 0, as in the reference.
Dense aggregation keeps a running f32 sum over clients (the reference's
sequential form), so only one client's server copy is alive at a time.
'seed_replay' aggregation replays all M·τ·P server records: in one sweep
for counter noise, record by record for threefry noise (``replay``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, SFLConfig
from repro_torch.core import prng, zo
from repro_torch.models import (client_forward, merge_params, server_forward,
                                split_params)
from repro_torch.utils import tree

Params = Any


class RoundMetrics(NamedTuple):
    loss: torch.Tensor           # (M,) round-start loss per client (f32)
    server_deltas: torch.Tensor  # (M, tau) mean SPSA deltas on the server
    client_delta: torch.Tensor   # (M,) client update coefficients


def _client_messages(cfg: ModelConfig, sfl: SFLConfig, xc: Params, batch,
                     ukey):
    """Three client forwards -> (h, h+, h-)."""
    dist = sfl.perturbation_dist
    h = client_forward(cfg, xc, batch)
    hp = client_forward(cfg, zo.perturb(xc, ukey, +sfl.zo_eps, dist), batch)
    hm = client_forward(cfg, zo.perturb(xc, ukey, -sfl.zo_eps, dist), batch)
    return h, hp, hm


def _server_tau_steps(cfg: ModelConfig, sfl: SFLConfig, xs: Params, h, batch,
                      skey, replay: str):
    """τ ZO steps on the stale h. Returns (xs_final, deltas (τ,),
    (keys (τ, P, 2), coeffs (τ, P)))."""
    def loss_of(sp):
        return server_forward(cfg, sp, h, batch)

    deltas, keys, coeffs = [], [], []
    for i in range(sfl.tau):
        xs, mean_delta, (pkeys, c) = zo.spsa_step(
            loss_of, xs, prng.fold_in(skey, i), sfl.zo_eps, sfl.lr_server,
            sfl.n_perturbations, sfl.perturbation_dist, replay)
        deltas.append(mean_delta)
        keys.append(pkeys)
        coeffs.append(c)
    return xs, torch.stack(deltas), (np.stack(keys), torch.stack(coeffs))


def _client_round(cfg: ModelConfig, sfl: SFLConfig, xc: Params, xs: Params,
                  batch, mkey, eval_loss: bool, replay: str
                  ) -> Dict[str, Any]:
    ukey = prng.fold_in(mkey, 0)
    skey = prng.fold_in(mkey, 1)
    h, hp, hm = _client_messages(cfg, sfl, xc, batch, ukey)
    loss0 = (server_forward(cfg, xs, h, batch) if eval_loss
             else torch.zeros((), dtype=torch.float32,
                              device=tree.leaves(xs)[0].device))
    xs_f, deltas, (keys, coeffs) = _server_tau_steps(cfg, sfl, xs, h, batch,
                                                     skey, replay)
    # ZO backprop (Eq. 6): the scalar comes from the final server model
    delta_c = (server_forward(cfg, xs_f, hp, batch)
               - server_forward(cfg, xs_f, hm, batch)).to(torch.float32)
    return {"xs_final": xs_f, "deltas": deltas, "srv_keys": keys,
            "srv_coeffs": coeffs, "ukey": ukey,
            "ccoeff": sfl.lr_client * delta_c / (2.0 * sfl.zo_eps),
            "loss0": loss0}


@torch.inference_mode()
def mu_splitfed_round(cfg: ModelConfig, sfl: SFLConfig, params: Params,
                      batches: Dict[str, torch.Tensor],
                      active_mask: torch.Tensor, round_key, *,
                      client_mode: str = "parallel",
                      aggregation: str = "dense", replay: str = "auto",
                      eval_loss: bool = True
                      ) -> Tuple[Params, RoundMetrics]:
    """One global round. ``batches`` leaves have a leading M dim;
    ``active_mask`` is (M,) participation weights (0 = dropped);
    ``round_key`` is a raw (2,) uint32 key. ``client_mode`` ('parallel' |
    'sequential') is accepted for the reference's signature: both are the
    one client loop here. ``replay`` ('auto' | 'fused' | 'scan') picks how
    records are applied (``zo.fused_replay_updates``); with ``eval_loss``
    False the round-start losses are not computed (zeros). Returns
    (new_params, metrics)."""
    if client_mode not in ("parallel", "sequential"):
        raise ValueError(f"client_mode must be parallel|sequential, got "
                         f"{client_mode!r}")
    if aggregation not in ("dense", "seed_replay"):
        raise ValueError(f"aggregation must be dense|seed_replay, got "
                         f"{aggregation!r}")
    M = sfl.n_clients
    xc, xs = split_params(cfg, params, sfl.cut_units)
    mask = active_mask.to(torch.float32)
    w = mask / mask.sum().clamp(min=1.0)              # (M,) aggregation wts
    acc = (tree.tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                               device=g.device), xs)
           if aggregation == "dense" else None)
    outs = []
    for m in range(M):
        r = _client_round(cfg, sfl, xc, xs, {k: v[m] for k, v in
                                             batches.items()},
                          prng.fold_in(round_key, m), eval_loss, replay)
        if acc is not None:
            acc = tree.tree_map(
                lambda a, f, g: a + w[m] * (f - g).to(torch.float32),
                acc, r.pop("xs_final"), xs)
        else:
            r.pop("xs_final")
        outs.append(r)

    if acc is not None:  # Eq. 7: x_s' = x_s + η_g Σ w_m (x_{s,m}^τ − x_s)
        xs_new = tree.tree_map(
            lambda g, a: (g + sfl.lr_global * a).to(g.dtype), xs, acc)
    else:                # replay all (M, τ, P) records, weighted η_g·w_m
        xs_new = zo.replay_weighted_records(
            xs, np.stack([o["srv_keys"] for o in outs]),
            torch.stack([o["srv_coeffs"] for o in outs]),
            sfl.lr_global * w, sfl.perturbation_dist, replay)
    # client aggregation: each client's update is one record in u_m
    ccoeff = torch.stack([o["ccoeff"] for o in outs])
    xc_new = zo.replay_weighted_records(
        xc, np.stack([o["ukey"] for o in outs]), ccoeff, sfl.lr_global * w,
        sfl.perturbation_dist, replay)
    metrics = RoundMetrics(loss=torch.stack([o["loss0"] for o in outs]),
                           server_deltas=torch.stack([o["deltas"]
                                                      for o in outs]),
                           client_delta=ccoeff)
    return merge_params(cfg, xc_new, xs_new), metrics


def mu_split_round(cfg: ModelConfig, sfl: SFLConfig, params: Params, batch,
                   round_key) -> Tuple[Params, RoundMetrics]:
    """MU-Split: the single-client (M=1, SL) case of Sec. 4.1."""
    sfl1 = (sfl if sfl.n_clients == 1
            else dataclasses.replace(sfl, n_clients=1))
    batches = {k: v[None] for k, v in batch.items()}
    mask = torch.ones((1,), dtype=torch.float32,
                      device=batches["tokens"].device)
    return mu_splitfed_round(cfg, sfl1, params, batches, mask, round_key)
