"""Port parity: more cases of the synchronous engine
(``repro_torch.core.engine.run_rounds``) against the reference's
``repro.core.engine.run_rounds(mode='python')``: the sphere's noise under
both aggregations, two perturbations a client under each noise, and an
adapter whose round_mask differs from the schedule's masks (the mask
split: the schedule's masks set the simulated round times and what a
controller sees; the round_mask rows are what the rounds consume).

Tolerances as in test_torch_engine.py: masks, simulated round times and τ
decisions are host numpy and must be identical; losses and parameters of
the f32 olmo-1b SMOKE model, cut to 2 layers (one a side) to keep the
file's time down, within 1e-4 after 4 rounds.
"""
import jax
import numpy as np
import pytest

from one_torch_thread import one_torch_thread  # noqa: F401
from repro.configs import SFLConfig as JSFL
from repro.configs import get_config as j_get_config
from repro.core import engine as jengine
from repro.core import straggler as jstrag
from repro.data import FederatedLoader as JLoader
from repro.data import SyntheticLM as JSynthetic
from repro.data import dirichlet_partition as j_partition
from repro.models import init_params as j_init
from repro.models import untie_params as j_untie
from repro_torch.configs import SFLConfig as TSFL
from repro_torch.configs import get_config as t_get_config
from repro_torch.core import engine as tengine
from repro_torch.core import prng
from repro_torch.core import straggler as tstrag
from repro_torch.data import FederatedLoader as TLoader
from repro_torch.data import SyntheticLM as TSynthetic
from repro_torch.data import dirichlet_partition as t_partition
from repro_torch.models.convert import from_jax_params, to_jax_params
from repro_torch.utils import tree

SEED, ROUNDS, M = 0, 4, 3


class JFreshMedian(jengine.MuSplitFed):
    """MU-SplitFed whose rounds consume the schedule's fresh_median rows
    (GAS's fresh='median' rule) in place of its masks."""

    def round_mask(self, sched, r):
        return sched.fresh_median[r % sched.n_rounds]


class TFreshMedian(tengine.MuSplitFed):
    def round_mask(self, sched, r):
        return sched.fresh_median[r % sched.n_rounds]


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


def _run_both(olmo, *, dist, aggregation, P, fresh_median=False):
    """4 rounds in chunks of 2 of each engine on one straggler schedule (3
    clients, participation 2/3, exponential delays) with AdaptiveTau.
    Returns {side: (result, controller, chunk masks, schedule)}."""
    jcfg, tcfg, jp, tp = olmo
    kw = dict(n_clients=M, tau=2, n_perturbations=P, cut_units=1,
              perturbation_dist=dist, participation=0.67,
              straggler_rate=2.0)
    parts = dict(labels=np.arange(256) % 10, n_clients=M, alpha=0.5,
                 seed=SEED)
    runs = {}
    for side, eng, strag, SFL, cfg, params, loader, key, fresh in (
            ("ref", jengine, jstrag, JSFL, jcfg, jp,
             JLoader(JSynthetic(jcfg.vocab_size, 16, SEED),
                     j_partition(**parts), 1, seed=SEED),
             jax.random.PRNGKey(SEED), JFreshMedian),
            ("port", tengine, tstrag, TSFL, tcfg, tp,
             TLoader(TSynthetic(tcfg.vocab_size, 16, SEED),
                     t_partition(**parts), 1, seed=SEED),
             prng.PRNGKey(SEED), TFreshMedian)):
        sfl = SFL(**kw)
        sched = strag.make_schedule(
            SEED, ROUNDS, population=strag.ClientPopulation.resolve(sfl),
            t_server=0.5, t_gen=0.3, t_comm=0.2)
        algo = (fresh(aggregation=aggregation) if fresh_median
                else eng.get_algorithm("mu_splitfed",
                                       aggregation=aggregation))
        ctl = eng.AdaptiveTau(tau_max=4)
        masks = []
        res = eng.run_rounds(
            eng.get_algorithm(algo), cfg, sfl, params, loader.round_batch,
            sched, key, rounds=ROUNDS, chunk_size=2, mode="python",
            controller=ctl,
            chunk_callback=lambda info, p, s: masks.append(info.masks))
        runs[side] = (res, ctl, np.concatenate(masks), sched)
    return runs


def _assert_same(runs):
    """Identical masks, simulated times and τ decisions; losses and
    parameters within 1e-4."""
    (jr, jctl, jm, _), (tr, tctl, tm, _) = runs["ref"], runs["port"]
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_equal(tr.round_times, jr.round_times)
    assert tr.sim_time == jr.sim_time
    np.testing.assert_array_equal(tr.tau_per_round, jr.tau_per_round)
    assert tctl.trace == jctl.trace and tctl.trace
    assert np.isfinite(tr.round_loss).all()
    np.testing.assert_allclose(tr.round_loss, jr.round_loss, atol=1e-4)
    for k in jr.metrics:
        assert tr.metrics[k].shape == jr.metrics[k].shape, k
    assert _maxdiff(tr.params, jr.params) <= 1e-4


@pytest.mark.parametrize("dist,P,aggregation", [
    ("sphere", 1, "dense"), ("sphere", 1, "seed_replay"),
    ("gaussian", 2, "dense"), ("sphere", 2, "seed_replay"),
    ("counter", 2, "dense")])
def test_run_rounds_cases_match_reference_engine(olmo_f32, dist, P,
                                                 aggregation):
    _assert_same(_run_both(olmo_f32, dist=dist, aggregation=aggregation,
                           P=P))


def test_run_rounds_keeps_the_mask_split(olmo_f32):
    """An adapter whose round_mask is the schedule's fresh_median rows,
    passed as a ready-made Algorithm to both engines: the round times and
    AdaptiveTau's window come from the schedule's masks, the rounds and
    the loss weights from fresh_median, on both sides."""
    runs = _run_both(olmo_f32, dist="counter", aggregation="dense", P=1,
                     fresh_median=True)
    sched = runs["port"][3]
    fresh, masks = sched.fresh_median[:ROUNDS], sched.masks[:ROUNDS]
    assert not np.array_equal(fresh, masks)
    np.testing.assert_array_equal(runs["port"][2], fresh)
    _assert_same(runs)
