"""Port parity: the host schedules (``repro_torch.core.straggler`` and
``population``) and the synchronous engine (``repro_torch.core.engine``)
against the reference's, and the driver's straggler and adaptive-τ flags.

Tolerances: schedules, masks, simulated round times and τ decisions are
host numpy and must be identical. Losses of the f32 olmo-1b SMOKE model
within 1e-4 and parameters within 1e-4 after 4 rounds (the threefry
gaussian is within 1e-6 of jax's, test_torch_threefry.py).
"""
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
from repro_torch.launch import train as t_train
from repro_torch.models.convert import from_jax_params, to_jax_params
from repro_torch.utils import tree

SCHEDULES = [
    dict(seed=0, n_clients=4, straggler_scale=2.0, participation=0.75),
    dict(seed=3, n_clients=6, straggler_scale=1.0, deadline=1.5,
         t_server=0.5, t_comm=0.2),
    dict(seed=7, population="tiered:4x1.0,12x0.2", straggler_scale=0.5),
    dict(seed=1, population="tiered:2x1.0@0.5~0.2/0.5,3x0.3%2.0",
         straggler_scale=1.0, deadline=4.0, t_gen=0.3),
    dict(seed=5, population="tiered:3x1.0,3x0.25~~0.3/0.4"),
]


def _schedules(strag, kw, rounds=12):
    kw = dict(kw)
    pop = kw.pop("population", None)
    if pop is not None:
        kw["population"] = strag.parse_population(
            pop, straggler_scale=kw.pop("straggler_scale", 0.0))
    seed = kw.pop("seed")
    dense = strag.make_schedule(seed, rounds, **kw)
    kw.pop("deadline", None)
    return dense, strag.make_sparse_schedule(seed, rounds, **kw)


@pytest.mark.parametrize("kw", SCHEDULES)
def test_schedules_bit_identical(kw):
    """Single cohorts (participation, deadline, comm), tiered fleets with
    per-client and shared Markov chains: every (R, M) array, the time
    models, plan_tau and the sparse schedule's rows are the reference's."""
    (jd, js), (td, ts) = _schedules(jstrag, kw), _schedules(tstrag, kw)
    for f in ("delays", "participation", "deadline", "masks", "fresh_median"):
        a, b = getattr(td, f), getattr(jd, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert (td.t_comm_scale is None) == (jd.t_comm_scale is None)
    if jd.t_comm_scale is not None:
        np.testing.assert_array_equal(td.t_comm_scale, jd.t_comm_scale)
    for r in range(td.n_rounds):
        d, m = jd.delays[r], jd.masks[r]
        for name in ("mu_splitfed", "vanilla", "gas", "local_only"):
            args = ((d, m, jd.t_server, jd.t_gen, jd.comm_for(m))
                    if name == "gas" else (d, m, jd.comm_for(m))
                    if name == "local_only"
                    else (d, m, jd.t_server, 3, jd.comm_for(m))
                    if name == "mu_splitfed"
                    else (d, m, jd.t_server, jd.comm_for(m)))
            assert (getattr(tstrag, f"round_time_{name}")(*args)
                    == getattr(jstrag, f"round_time_{name}")(*args))
        row_t, row_j = ts.avail_row(r), js.avail_row(r)
        M = jd.n_clients
        np.testing.assert_array_equal(row_t.densify(M), row_j.densify(M))
        ids = np.arange(M)
        np.testing.assert_array_equal(ts.delays_for(r, ids),
                                      js.delays_for(r, ids))
    for t in (0.0, 0.3, 2.0, 50.0):
        assert tstrag.plan_tau(t, 0.5, 8) == jstrag.plan_tau(t, 0.5, 8)
    spec = kw.get("population")
    if spec:
        assert (tstrag.parse_population(spec).describe()
                == jstrag.parse_population(spec).describe())


@pytest.fixture(scope="module")
def olmo_f32():
    jcfg = j_get_config("olmo-1b", smoke=True).replace(dtype="float32")
    tcfg = t_get_config("olmo-1b", smoke=True).replace(dtype="float32")
    params = j_untie(jcfg, j_init(jcfg, jax.random.PRNGKey(0)))
    return jcfg, tcfg, params, from_jax_params(params)


def _maxdiff(t_tree, j_tree):
    got = tree.leaves(to_jax_params(t_tree))
    want = jax.tree.leaves(j_tree)
    return max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
               for a, b in zip(got, want))


@pytest.mark.parametrize("aggregation", ["dense", "seed_replay"])
@pytest.mark.parametrize("dist", ["gaussian", "counter"])
def test_run_rounds_matches_reference_engine(olmo_f32, dist, aggregation):
    """4 rounds in chunks of 2 on a straggler schedule (3 clients,
    participation 2/3, exponential delays) with AdaptiveTau, against
    ``repro.core.engine.run_rounds(mode='python')``: the same masks,
    simulated round times and τ decisions (τ 2 -> 4 at round 2, with η_s
    rescaled), losses and parameters within 1e-4."""
    jcfg, tcfg, jp, tp = olmo_f32
    seed, rounds, M = 0, 4, 3
    kw = dict(n_clients=M, tau=2, n_perturbations=1, cut_units=2,
              perturbation_dist=dist, participation=0.67,
              straggler_rate=2.0)
    parts = dict(labels=np.arange(256) % 10, n_clients=M, alpha=0.5,
                 seed=seed)
    jloader = JLoader(JSynthetic(jcfg.vocab_size, 16, seed),
                      j_partition(**parts), 1, seed=seed)
    tloader = TLoader(TSynthetic(tcfg.vocab_size, 16, seed),
                      t_partition(**parts), 1, seed=seed)
    runs = {}
    for side, eng, strag, SFL, cfg, params, loader, key in (
            ("ref", jengine, jstrag, JSFL, jcfg, jp, jloader,
             jax.random.PRNGKey(seed)),
            ("port", tengine, tstrag, TSFL, tcfg, tp, tloader,
             prng.PRNGKey(seed))):
        sfl = SFL(**kw)
        sched = strag.make_schedule(
            seed, rounds, population=strag.ClientPopulation.resolve(sfl),
            t_server=0.5, t_gen=0.3, t_comm=0.2)
        ctl = eng.AdaptiveTau(tau_max=4)
        masks = []
        res = eng.run_rounds(
            eng.get_algorithm("mu_splitfed", aggregation=aggregation), cfg,
            sfl, params, loader.round_batch, sched, key, rounds=rounds,
            chunk_size=2, mode="python", controller=ctl,
            chunk_callback=lambda info, p, s: masks.append(info.masks))
        runs[side] = (res, ctl, np.concatenate(masks))
    (jr, jctl, jm), (tr, tctl, tm) = runs["ref"], runs["port"]
    np.testing.assert_array_equal(tm, jm)
    assert (tm == 0).any() and (tm > 0).any()        # someone was dropped
    np.testing.assert_array_equal(tr.round_times, jr.round_times)
    assert tr.sim_time == jr.sim_time
    np.testing.assert_array_equal(tr.tau_per_round, jr.tau_per_round)
    assert tctl.trace == jctl.trace == [(2, 4)]
    np.testing.assert_allclose(tr.round_loss, jr.round_loss, atol=1e-4)
    for k in jr.metrics:
        assert tr.metrics[k].shape == jr.metrics[k].shape, k
    assert _maxdiff(tr.params, jr.params) <= 1e-4


def test_engine_raises_for_what_is_not_ported(olmo_f32):
    """The semi-async engine is ported (tests/test_torch_async.py): what
    the engine still refuses are the reference's own argument errors,
    mode='async' on an algorithm without async_round_fn and an unknown
    algorithm."""
    _, tcfg, _, tp = olmo_f32
    sched = tstrag.make_schedule(0, 2, 2)
    args = ("mu_splitfed", tcfg, TSFL(n_clients=2), tp, lambda r: {},
            sched, prng.PRNGKey(0))
    with pytest.raises(ValueError, match="has no async_round_fn"):
        tengine.run_rounds(*args, rounds=2, mode="async")
    with pytest.raises(ValueError, match="unknown algorithm"):
        tengine.get_algorithm("async_splitfed")
    assert tengine.get_algorithm("async_mu_splitfed").name == \
        "async_mu_splitfed"


def test_driver_straggler_flags_match_reference_schedule():
    """The driver's reference flags on the CPU at SMOKE size: gaussian
    noise by default, the straggler schedule's masks and simulated times,
    and adaptive τ's decision, as the reference driver's schedule and
    planner give them."""
    argv = ["--smoke", "--device", "cpu", "--rounds", "4", "--seq", "8",
            "--clients", "4", "--batch", "1", "--participation", "0.75",
            "--straggler-scale", "2.0", "--t-server", "0.5", "--t-gen",
            "0.3", "--t-comm", "0.2", "--adaptive-tau", "--tau-max", "4",
            "--chunk-size", "2", "--aggregation", "seed_replay"]
    run = t_train.setup(argv)
    assert run.sfl.perturbation_dist == "gaussian"
    lines = []
    res, ctl = t_train.run_engine(run, log=lines.append)
    assert np.isfinite(res.round_loss).all() and len(res.round_loss) == 4
    jsfl = JSFL(n_clients=4, participation=0.75, straggler_rate=2.0)
    jsched = jstrag.make_schedule(
        0, 4, population=jstrag.ClientPopulation.resolve(jsfl),
        t_server=0.5, t_gen=0.3, t_comm=0.2)
    taus = [2, 2, 4, 4]
    want = [jstrag.round_time_mu_splitfed(
        jsched.delays[r], jsched.masks[r], 0.5, taus[r],
        jsched.comm_for(jsched.masks[r])) for r in range(4)]
    np.testing.assert_array_equal(res.round_times, want)
    np.testing.assert_array_equal(res.tau_per_round, taus)
    assert ctl.trace == [(2, 4)]
    active = [int((jsched.masks[r] > 0).sum()) for r in range(4)]
    assert [ln.split("active ")[1].split()[0] for ln in lines[:4]] == \
        [f"{a}/4" for a in active]
    assert lines[-1].startswith("adaptive tau (sim): start 2 -> final 4")
    pop = t_train.setup(["--smoke", "--device", "cpu", "--population",
                         "tiered:2x1.0,3x0.2"])
    assert pop.sfl.n_clients == 5 and pop.sfl.population is not None
