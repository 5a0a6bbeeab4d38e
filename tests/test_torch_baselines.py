"""Port parity: the zeroth-order baselines (``repro_torch.core.baselines``
and the engine's ``vanilla`` and ``gas`` adapters) against the
reference's ``repro.core.engine.run_rounds(mode='python')``, and the
reference's GAS semantics tests run on the port.

Tolerances: masks, simulated round times and τ decisions are host numpy
and must be identical, as must GAS's buffered batches (integers). Losses
and parameters of the f32 olmo-1b SMOKE model, cut to 2 layers (one a
side) to keep the file's time down, within 1e-4 after 4 rounds. GAS's
buffered activations: the fresh rows within 1e-5 of the reference's
client forward on the port's own parameters and batch of that round (the
buffer's semantics), and the whole buffer within 1e-4 of the reference
run's. The latter is as loose as the parameters' bound because the two
runs' parameters differ by up to 7e-7 (f32 rounding, and the gaussian's
4.8e-7 gap to jax's), and OLMo's non-parametric LayerNorm over the
0.02-scale embedding amplifies that about 40× in h (2.2e-5 to 4.0e-5
measured). ``vanilla`` is the port's own ``mu_splitfed`` at τ=1 bit for
bit.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from one_torch_thread import one_torch_thread  # noqa: F401
from repro.configs import SFLConfig as JSFL
from repro.configs import get_config as j_get_config
from repro.core import engine as jengine
from repro.core import straggler as jstrag
from repro.data import FederatedLoader as JLoader
from repro.data import SyntheticLM as JSynthetic
from repro.data import dirichlet_partition as j_partition
from repro.models import client_forward as j_client_forward
from repro.models import init_params as j_init
from repro.models import split_params as j_split
from repro.models import untie_params as j_untie
from repro_torch.configs import SFLConfig as TSFL
from repro_torch.configs import get_config as t_get_config
from repro_torch.core import engine as tengine
from repro_torch.core import prng
from repro_torch.core import straggler as tstrag
from repro_torch.core.baselines import gas_init_state, gas_round
from repro_torch.data import FederatedLoader as TLoader
from repro_torch.data import SyntheticLM as TSynthetic
from repro_torch.data import dirichlet_partition as t_partition
from repro_torch.models import split_params
from repro_torch.models.convert import from_jax_params, to_jax_params
from repro_torch.utils import tree

SEED, ROUNDS, M = 0, 4, 3


@pytest.fixture(scope="module")
def olmo_f32():
    jcfg = j_get_config("olmo-1b", smoke=True).replace(dtype="float32",
                                                        n_layers=2)
    tcfg = t_get_config("olmo-1b", smoke=True).replace(dtype="float32",
                                                        n_layers=2)
    params = j_untie(jcfg, j_init(jcfg, jax.random.PRNGKey(0)))
    return jcfg, tcfg, params, from_jax_params(params)


def _maxdiff(t_tree, j_tree):
    got = tree.leaves(to_jax_params(t_tree))
    want = jax.tree.leaves(j_tree)
    return max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
               for a, b in zip(got, want))


def _sfl_kw(dist):
    return dict(n_clients=M, tau=2, n_perturbations=1, cut_units=1,
                perturbation_dist=dist, participation=0.67,
                straggler_rate=2.0)


def _loaders(jcfg, tcfg):
    parts = dict(labels=np.arange(256) % 10, n_clients=M, alpha=0.5,
                 seed=SEED)
    return (JLoader(JSynthetic(jcfg.vocab_size, 16, SEED),
                    j_partition(**parts), 1, seed=SEED),
            TLoader(TSynthetic(tcfg.vocab_size, 16, SEED),
                    t_partition(**parts), 1, seed=SEED))


def _run(eng, strag, SFL, cfg, params, loader, key, algorithm, opts, dist,
         controller=True, **sfl_kw):
    sfl = SFL(**{**_sfl_kw(dist), **sfl_kw})
    sched = strag.make_schedule(
        SEED, ROUNDS, population=strag.ClientPopulation.resolve(sfl),
        t_server=0.5, t_gen=0.3, t_comm=0.2)
    ctl = eng.AdaptiveTau(tau_max=4) if controller else None
    masks, seen = [], []

    def on_chunk(info, p, s):
        masks.append(info.masks)
        seen.append(p)

    res = eng.run_rounds(
        eng.get_algorithm(algorithm, **opts), cfg, sfl, params,
        loader.round_batch, sched, key, rounds=ROUNDS, chunk_size=2,
        mode="python", controller=ctl, chunk_callback=on_chunk)
    return res, ctl, np.concatenate(masks), seen


# (algorithm, options, noise, starting τ). From τ=2 AdaptiveTau moves τ
# to 4 and rescales η_s at round 2, which makes the reference compile its
# round twice; the other cases start at the τ it decides (4), where the
# decision changes nothing, to keep the file's time down.
CASES = [("vanilla", {"aggregation": "dense"}, "gaussian", 4),
         ("vanilla", {"aggregation": "seed_replay"}, "gaussian", 4),
         ("gas", {"fresh": "mask", "aggregation": "dense"}, "gaussian", 2),
         ("gas", {"fresh": "mask", "aggregation": "seed_replay"},
          "gaussian", 4),
         ("gas", {"fresh": "median", "aggregation": "dense"}, "gaussian",
          4),
         ("gas", {"fresh": "median", "aggregation": "seed_replay"},
          "gaussian", 4),
         ("gas", {"fresh": "mask", "aggregation": "seed_replay"},
          "counter", 4)]


@pytest.mark.parametrize("algorithm,opts,dist,tau", CASES,
                         ids=[f"{a}-{'-'.join(o.values())}-{d}"
                              for a, o, d, _ in CASES])
def test_baseline_matches_reference_engine(olmo_f32, algorithm, opts, dist,
                                           tau):
    """4 rounds in chunks of 2 on one straggler schedule (3 clients at
    participation 2/3, exponential delays) with AdaptiveTau, against the
    reference engine's python mode: the same masks, simulated round
    times and τ decisions, losses and parameters within 1e-4, and GAS's
    buffers (the module docstring's tolerances; batches identical)."""
    jcfg, tcfg, jp, tp = olmo_f32
    jl, tl = _loaders(jcfg, tcfg)
    jr, jctl, jm, _ = _run(jengine, jstrag, JSFL, jcfg, jp, jl,
                           jax.random.PRNGKey(SEED), algorithm, opts, dist,
                           tau=tau)
    tr, tctl, tm, seen = _run(tengine, tstrag, TSFL, tcfg, tp, tl,
                              prng.PRNGKey(SEED), algorithm, opts, dist,
                              tau=tau)
    np.testing.assert_array_equal(tm, jm)
    assert (tm == 0).any() and (tm > 0).any()     # a client was stale
    np.testing.assert_array_equal(tr.round_times, jr.round_times)
    assert tr.sim_time == jr.sim_time
    np.testing.assert_array_equal(tr.tau_per_round, jr.tau_per_round)
    assert tctl.trace == jctl.trace == [(2, 4)]
    assert list(tr.tau_per_round) == [tau, tau, 4, 4]
    np.testing.assert_allclose(tr.round_loss, jr.round_loss, atol=1e-4)
    for k in jr.metrics:
        assert tr.metrics[k].shape == jr.metrics[k].shape, k
        np.testing.assert_allclose(tr.metrics[k], jr.metrics[k], atol=1e-4)
    assert _maxdiff(tr.params, jr.params) <= 1e-4
    if algorithm == "gas":
        h = tr.state.h_buffer["h"].numpy()
        np.testing.assert_allclose(h, np.asarray(jr.state.h_buffer["h"]),
                                   atol=1e-4)
        # the last round's fresh rows: the reference's client forward on
        # the parameters that round started from (python mode calls back
        # after every round) and that round's batch
        xc, _ = j_split(jcfg, to_jax_params(seen[-2]), 1)
        last = jl.round_batch(ROUNDS - 1)
        fresh = np.flatnonzero(tm[-1] > 0)
        assert fresh.size
        for m in fresh:
            want = j_client_forward(jcfg, xc, {k: v[m] for k, v in
                                               last.items()})["h"]
            np.testing.assert_allclose(h[m], np.asarray(want), atol=1e-5)
        for k in jr.state.label_buffer:
            np.testing.assert_array_equal(
                tr.state.label_buffer[k].numpy(),
                np.asarray(jr.state.label_buffer[k]))


@pytest.mark.parametrize("aggregation", ["dense", "seed_replay"])
def test_vanilla_is_mu_splitfed_at_tau_1(olmo_f32, aggregation):
    """The port's vanilla run (τ=2 in its config) and its MU-SplitFed run
    at τ=1: parameters, losses and metrics bit for bit; only the time
    model differs."""
    _, tcfg, _, tp = olmo_f32
    tl = _loaders(*olmo_f32[:2])[1]
    args = (tengine, tstrag, TSFL, tcfg, tp, tl, prng.PRNGKey(SEED))
    opts = {"aggregation": aggregation}
    van = _run(*args, "vanilla", opts, "gaussian", controller=False)[0]
    mu = _run(*args, "mu_splitfed", opts, "gaussian", controller=False,
              tau=1)[0]
    for a, b in zip(tree.leaves(van.params), tree.leaves(mu.params)):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(van.round_loss, mu.round_loss)
    for k in mu.metrics:
        np.testing.assert_array_equal(van.metrics[k], mu.metrics[k])
    assert van.metrics["server_deltas"].shape == (ROUNDS, M, 1)
    assert not np.array_equal(van.round_times, mu.round_times)


@pytest.fixture(scope="module")
def gas_setup(olmo_f32):
    _, tcfg, _, tp = olmo_f32
    toks = np.random.default_rng(1).integers(0, tcfg.vocab_size, (M, 2, 16))
    batches = {"tokens": torch.from_numpy(toks),
               "labels": torch.from_numpy(toks.copy())}
    sfl = TSFL(n_clients=M, tau=1, cut_units=1)
    return tcfg, tp, batches, sfl


def test_gas_stale_clients_use_buffer(gas_setup):
    """A stale client's server replica trains from the buffered
    activation: swapping that client's fresh data does not change the
    server half, and the buffer keeps the old activation for it."""
    cfg, params, batches, sfl = gas_setup
    state = gas_init_state(cfg, sfl, params, batches)
    fresh = torch.tensor([1.0, 0.0, 1.0])
    rk = prng.PRNGKey(2)
    p1, s1, _ = gas_round(cfg, sfl, params, state, batches, fresh, rk)
    b2 = {k: v.clone() for k, v in batches.items()}
    for v in b2.values():
        v[1] = torch.roll(v[1], 3, dims=-1)
    p2, _, _ = gas_round(cfg, sfl, params, state, b2, fresh, rk)
    _, xs1 = split_params(cfg, p1, 1)
    _, xs2 = split_params(cfg, p2, 1)
    assert max(float((a - b).abs().max()) for a, b in
               zip(tree.leaves(xs1), tree.leaves(xs2))) < 1e-6
    assert torch.equal(s1.h_buffer["h"][1], state.h_buffer["h"][1])
    assert torch.equal(s1.label_buffer["tokens"][1],
                       state.label_buffer["tokens"][1])


def test_gas_fresh_clients_update_buffer(gas_setup):
    cfg, params, batches, sfl = gas_setup
    state = gas_init_state(cfg, sfl, params, batches)
    b2 = {k: torch.roll(v, 1, dims=-1) for k, v in batches.items()}
    _, s2, _ = gas_round(cfg, sfl, params, state, b2, torch.ones(M),
                         prng.PRNGKey(3))
    assert float((s2.h_buffer["h"] - state.h_buffer["h"]).abs().max()) > 0
    assert torch.equal(s2.label_buffer["tokens"], b2["tokens"])


def test_gas_stale_nan_stays_nan(gas_setup):
    """A stale client's coefficient is fresh·η_c·δ_c/2λ, computed, not
    skipped: a non-finite δ_c stays non-finite, as in the reference."""
    cfg, params, batches, sfl = gas_setup
    state = gas_init_state(cfg, sfl, params, batches)
    bad = dataclasses.replace(sfl, zo_eps=float("inf"))
    _, _, m = gas_round(cfg, bad, params, state, batches,
                        torch.tensor([1.0, 0.0, 1.0]), prng.PRNGKey(4))
    assert torch.isnan(m.client_delta[1])
