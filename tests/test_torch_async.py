"""Port parity: the semi-async event engine (``AsyncMuSplitFed``,
``AdaptiveQuorum``, ``run_rounds(mode='async')`` on the dense and the
sparse timeline, the record store's device half in ``core/events.py``)
and the driver's --async, --faults and kill=R against the JAX package, on
the CPU, at SMOKE size in f32 (olmo-1b, 4 clients).

Tolerances. Against the reference: apply weights (the masks), simulated
round times and fault counters exact; losses, parameters and the store's
coefficients within 1e-5; the store's keys exact. Checkpoints cross-load
bit-exactly both ways. A resumed port run is bit-identical to an
uninterrupted port run (losses np.array_equal, leaves torch.equal), in
the engine and through the driver's SIGKILL.
"""
import os
import signal
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from one_torch_thread import one_torch_thread  # noqa: F401
from repro.ckpt import Checkpointer as JCheckpointer
from repro.configs import SFLConfig as JSFL
from repro.configs import get_config as j_get_config
from repro.core import engine as jengine
from repro.core import events as jev
from repro.core import faults as jfaults
from repro.core import straggler as jstrag
from repro.data import FederatedLoader as JLoader
from repro.data import SyntheticLM as JSynthetic
from repro.data import dirichlet_partition as j_partition
from repro.launch import train as j_train
from repro.models import init_params as j_init
from repro.models import untie_params as j_untie
from repro.obs import TelemetrySink as JSink
from repro.obs.telemetry import RoundTelemetry as JRecord
from repro_torch import obs
from repro_torch.ckpt import Checkpointer, read_meta
from repro_torch.configs import SFLConfig as TSFL
from repro_torch.configs import get_config as t_get_config
from repro_torch.core import engine as tengine
from repro_torch.core import events as tev
from repro_torch.core import faults as tfaults
from repro_torch.core import prng
from repro_torch.core import straggler as tstrag
from repro_torch.core.population import ClientPopulation, Cohort, DelayModel
from repro_torch.data import FederatedLoader as TLoader
from repro_torch.data import SyntheticLM as TSynthetic
from repro_torch.data import dirichlet_partition as t_partition
from repro_torch.launch import train as t_train
from repro_torch.models.convert import from_jax_params
from repro_torch.obs.telemetry import RoundTelemetry as TRecord
from repro_torch.utils import tree

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
M, SEED, ROUNDS = 4, 0, 4
ALGO = "async_mu_splitfed"
BASE = dict(n_clients=M, tau=2, n_perturbations=1, cut_units=2,
            participation=0.75, straggler_rate=2.0, quorum=2,
            staleness_discount=0.5)
PLAN = dict(crash=0.2, loss=0.2, dup=0.1, corrupt=0.1)
CASES = {
    "dense-counter": dict(perturbation_dist="counter"),
    "dense-gaussian-faults": dict(faults=PLAN, quorum_timeout=1.0),
    "sparse-counter-faults": dict(timeline="sparse",
                                  perturbation_dist="counter", faults=PLAN,
                                  quorum_timeout=1.0),
    "sparse-gaussian-ring": dict(timeline="sparse", k_max=2,
                                 ring_capacity=3),
}


@pytest.fixture(scope="module")
def olmo():
    jcfg = j_get_config("olmo-1b", smoke=True).replace(dtype="float32")
    tcfg = t_get_config("olmo-1b", smoke=True).replace(dtype="float32")
    params = j_untie(jcfg, j_init(jcfg, jax.random.PRNGKey(0)))
    return jcfg, tcfg, params, from_jax_params(params)


def _sfl_kw(case):
    return {**BASE, **CASES[case]}


def _side(olmo, side, sfl_kw):
    """(cfg, sfl, params, loader, schedule, key) of one package."""
    jcfg, tcfg, jp, tp = olmo
    sfl_kw = dict(sfl_kw)
    plan = sfl_kw.pop("faults", None)
    parts = dict(labels=np.arange(256) % 10, n_clients=sfl_kw["n_clients"],
                 alpha=0.5, seed=SEED)
    sched_kw = dict(t_server=0.5, t_comm=0.2)
    if side == "ref":
        sfl = JSFL(faults=plan and jfaults.FaultPlan(**plan), **sfl_kw)
        return (jcfg, sfl, jp,
                JLoader(JSynthetic(jcfg.vocab_size, 16, SEED),
                        j_partition(**parts), 1, seed=SEED),
                jstrag.make_schedule(
                    SEED, ROUNDS,
                    population=jstrag.ClientPopulation.resolve(sfl),
                    **sched_kw),
                jax.random.PRNGKey(SEED))
    sfl = TSFL(faults=plan and tfaults.FaultPlan(**plan), **sfl_kw)
    return (tcfg, sfl, tp,
            TLoader(TSynthetic(tcfg.vocab_size, 16, SEED),
                    t_partition(**parts), 1, seed=SEED),
            tstrag.make_schedule(
                SEED, ROUNDS, population=tstrag.ClientPopulation.resolve(sfl),
                **sched_kw),
            prng.PRNGKey(SEED))


def _run(eng, olmo, side, case, rounds=ROUNDS, chunk_size=2, **kw):
    """run_rounds(mode='async') of one side, recording each chunk's masks
    and the 'sim' telemetry; returns (EngineResult, masks, sim records)."""
    cfg, sfl, params, loader, sched, key = _side(olmo, side, _sfl_kw(case))
    masks = []
    sink = obs.TelemetrySink() if side == "port" else JSink()
    res = eng.run_rounds(kw.pop("algo", ALGO), cfg, sfl,
                         kw.pop("params", params), loader.round_batch, sched,
                         key, rounds=rounds, chunk_size=chunk_size,
                         mode="async", telemetry=sink,
                         chunk_callback=lambda i, p, s: masks.append(i.masks),
                         **kw)
    return res, np.concatenate(masks), list(sink.window(0, rounds, "sim"))


@pytest.fixture(scope="module")
def ref_runs(olmo, tmp_path_factory):
    """The reference's 4-version async run of each case, checkpointed every
    2 versions, once per case (one algorithm instance: one jit compile)."""
    cache = {}

    def get(case):
        if case not in cache:
            d = str(tmp_path_factory.mktemp(case))
            cache[case] = (d, *_run(jengine, olmo, "ref", case,
                                    checkpointer=JCheckpointer(d),
                                    ckpt_every=2))
        return cache[case]

    return get


def _maxdiff(port_tree, jax_tree) -> float:
    got = [np.asarray(a.float().numpy() if isinstance(a, torch.Tensor)
                      else a, np.float64)
           for _, a in tree.path_leaves(port_tree)]
    want = [np.asarray(b, np.float64)
            for b in jax.tree_util.tree_leaves(jax_tree)]
    assert len(got) == len(want)
    return max(float(np.abs(a - b).max()) for a, b in zip(got, want))


def _host(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _assert_bit_equal(port_tree, jax_tree):
    got = tree.path_leaves(port_tree)
    want = jax.tree_util.tree_flatten_with_path(jax_tree)[0]
    assert len(got) == len(want)
    for (k, a), (_, b) in zip(got, want):
        x, y = _host(a), _host(b)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), k


def _assert_port_equal(got, want):
    a, b = tree.path_leaves(got), tree.path_leaves(want)
    assert [k for k, _ in a] == [k for k, _ in b]
    for (k, x), (_, y) in zip(a, b):
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), k
        else:
            assert x.dtype == y.dtype and torch.equal(x, y), k


def _assert_store(port_store, ref_store):
    """Keys exact, coefficients and losses within TOL, same dtypes."""
    for k, v in port_store.items():
        want = np.asarray(ref_store[k])
        got = _host(v)
        assert got.dtype == want.dtype and got.shape == want.shape, k
        if got.dtype == np.uint32:
            assert np.array_equal(got, want), k
        else:
            assert np.abs(got - want).max() <= TOL, k


# ---------------------------------------------------------------------------
# the engine against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_async_run_matches_reference(olmo, ref_runs, case):
    """Four async versions in chunks of 2 on a straggler schedule at
    participation 0.75 (quorum 2, discount 0.5): apply weights, round
    times and every 'sim' telemetry field (quorum waits, fault counters)
    exact; losses, parameters and the store within 1e-5. The sparse cases
    stage through the loader's subset_batch (the reference gathers from
    the fleet-width batch), one with a tight ring (k_max 2, capacity 3)."""
    _, jres, jmasks, jsim = ref_runs(case)
    sparse = CASES[case].get("timeline") == "sparse"
    loader = _side(olmo, "port", _sfl_kw(case))[3]
    tres, tmasks, tsim = _run(
        tengine, olmo, "port", case,
        batch_subset_fn=loader.subset_batch if sparse else None)
    np.testing.assert_array_equal(tmasks, jmasks)
    np.testing.assert_array_equal(tres.round_times, jres.round_times)
    assert [r.to_json() | {"t_wall": 0} for r in tsim] == \
        [r.to_json() | {"t_wall": 0} for r in jsim]
    if "faults" in CASES[case]:
        assert sum(r.crashed + r.lost + r.corrupt for r in tsim) > 0
    np.testing.assert_allclose(tres.round_loss, jres.round_loss, atol=TOL)
    np.testing.assert_allclose(tres.metrics["loss"], jres.metrics["loss"],
                               atol=TOL)
    assert _maxdiff(tres.params, jres.params) <= TOL
    _assert_store(tres.state, jres.state)


def test_async_equals_scan_at_full_quorum(olmo):
    """quorum 0 and discount 1.0: mode='async' is mode='scan' with seed
    replay (the reference's gate): parameters and every applied client's
    loss bit for bit; the round losses within 1e-6, since async weighs
    them by the normalized apply weights (1/3 each) where scan weighs by
    the 0/1 mask and divides."""
    kw = {**BASE, "quorum": 0, "staleness_discount": 1.0,
          "perturbation_dist": "counter"}
    cfg, sfl, params, loader, sched, key = _side(olmo, "port", kw)
    sc = tengine.run_rounds("mu_splitfed", cfg, sfl, params,
                            loader.round_batch, sched, key, rounds=ROUNDS,
                            chunk_size=3, aggregation="seed_replay")
    asy = tengine.run_rounds(ALGO, cfg, sfl, params, loader.round_batch,
                             sched, key, rounds=ROUNDS, chunk_size=3,
                             mode="async")
    live = sched.masks[:ROUNDS] > 0
    assert np.array_equal(asy.metrics["loss"][live], sc.metrics["loss"][live])
    np.testing.assert_allclose(asy.round_loss, sc.round_loss, atol=1e-6)
    _assert_port_equal(asy.params, sc.params)
    sp = tengine.run_rounds(ALGO, cfg, TSFL(**{**kw, "timeline": "sparse"}),
                            params, loader.round_batch, sched, key,
                            rounds=ROUNDS, chunk_size=3, mode="async")
    np.testing.assert_array_equal(sp.round_times, asy.round_times)
    np.testing.assert_allclose(sp.round_loss, asy.round_loss, atol=TOL)


def test_argument_errors_match_reference(olmo):
    """The engine's and the adapter's errors carry the reference's
    messages."""
    cfg, sfl, params, loader, sched, key = _side(olmo, "port", BASE)
    bad = [(lambda e: e.get_algorithm(ALGO, aggregation="dense"), {}),
           (lambda e: e.get_algorithm(ALGO, client_mode="sequential"), {})]
    calls = [
        ("mu_splitfed", BASE, dict(mode="async")),
        ("mu_splitfed", {**BASE, "timeline": "sparse"}, dict(mode="scan")),
        ("mu_splitfed", {**BASE, "timeline": "ring"}, dict(mode="scan")),
        (ALGO, BASE, dict(mode="async", batch_subset_fn=lambda r, i: None)),
        (ALGO, BASE, dict(mode="turbo"))]
    for side, eng in (("ref", jengine), ("port", tengine)):
        msgs = []
        for fn, _ in bad:
            with pytest.raises(ValueError) as e:
                fn(eng)
            msgs.append(str(e.value))
        for algo, kw, run_kw in calls:
            cfg, sfl, params, loader, sched, key = _side(olmo, side, kw)
            with pytest.raises(ValueError) as e:
                eng.run_rounds(algo, cfg, sfl, params, loader.round_batch,
                               sched, key, rounds=2, **run_kw)
            msgs.append(str(e.value))
        if side == "ref":
            want = msgs
    assert msgs == want


def test_resize_store_matches_reference():
    """Growth zero-pads the τ axis, shrink truncates it, the same τ is the
    same store: each as the reference's, on a store with records."""
    rng = np.random.default_rng(0)
    kw = dict(n_clients=3, tau=4, n_perturbations=2)
    jstore = jev.init_store(JSFL(**kw))
    tstore = tev.init_store(TSFL(**kw))
    keys = rng.integers(0, 2**32, (3, 4, 2, 2), dtype=np.uint32)
    coeffs = rng.standard_normal((3, 4, 2)).astype(np.float32)
    jstore = {**jstore, "srv_keys": jax.numpy.asarray(keys),
              "srv_coeffs": jax.numpy.asarray(coeffs)}
    tstore = {**tstore, "srv_keys": keys, "srv_coeffs": torch.tensor(coeffs)}
    assert tev.resize_store(tstore, 4) is tstore
    for tau in (6, 2, 1):
        got, want = tev.resize_store(tstore, tau), jev.resize_store(jstore,
                                                                    tau)
        assert isinstance(got["srv_keys"], np.ndarray)
        _assert_bit_equal(got, want)
        tstore, jstore = got, want


def test_adaptive_quorum_matches_reference():
    """AdaptiveQuorum's decisions, trace and state_dict equal the
    reference's over the same windows, and its errors."""
    def window(pkg, eng, started, dropped):
        rec = pkg(0, 4, "sim", "async", np.full(4, 0.1), started=started,
                  crashed=dropped // 2, lost=dropped - dropped // 2)
        return eng.SchedWindow(0, 4, np.zeros((4, M)), np.ones((4, M)),
                               0.1, 0.0, telemetry=(rec,))

    runs = []
    for pkg, eng, sfl in ((JRecord, jengine, JSFL), (TRecord, tengine, TSFL)):
        ctl = eng.AdaptiveQuorum(k_min=1, ema=0.5)
        ctl.bind(sfl(n_clients=8, quorum=6))
        out = [ctl.update(r, window(pkg, eng, s, d), {}) for r, (s, d) in
               enumerate([(20, 10), (20, 0), (20, 20), (0, 0), (17, 3)])]
        out.append(ctl.update(9, None, {}))
        fresh = eng.AdaptiveQuorum()
        fresh.load_state_dict(ctl.state_dict())
        runs.append((out, ctl.trace, ctl.state_dict(), fresh.state_dict()))
        with pytest.raises(ValueError) as e1:
            eng.AdaptiveQuorum(k_min=0)
        with pytest.raises(ValueError) as e2:
            eng.AdaptiveQuorum().bind(sfl(n_clients=8, quorum=0))
        runs[-1] += (str(e1.value), str(e2.value))
    assert runs[0] == runs[1]


# ---------------------------------------------------------------------------
# checkpoints: cross-loading and bit-identical resume
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["dense-counter", "sparse-counter-faults"])
def test_async_checkpoints_cross_load(olmo, ref_runs, tmp_path, case):
    """The {'params','state'} bundle with the record store: the
    reference's checkpoint after version 1 restores into the port's
    restore_run (keys as numpy uint32) bit-equal to the reference's own
    restore, and the port continues it to the reference's trajectory; the
    port's restores into the reference's, which continues it the same
    way."""
    jd, jres, _, _ = ref_runs(case)
    kw = _sfl_kw(case)
    tcfg, tsfl, tp, tl, tsched, tkey = _side(olmo, "port", kw)
    jcfg, jsfl, jp, jl, jsched, jkey = _side(olmo, "ref", kw)
    jalgo = jengine.get_algorithm(ALGO)
    jparams, jstate, _ = jengine.restore_run(JCheckpointer(jd), jalgo, jcfg,
                                             jsfl, jp, jl.round_batch, step=1)
    # reference -> port
    p, s, meta = tengine.restore_run(Checkpointer(jd), ALGO, tcfg, tsfl, tp,
                                     tl.round_batch, step=1)
    assert meta["metadata"]["has_state"] is True
    assert isinstance(s["srv_keys"], np.ndarray) and \
        s["srv_keys"].dtype == np.uint32
    _assert_bit_equal(p, jparams)
    _assert_bit_equal(s, jstate)
    t2, _, _ = _run(tengine, olmo, "port", case, params=p, state=s,
                    start_round=2)
    np.testing.assert_array_equal(t2.round_times, jres.round_times[2:])
    np.testing.assert_allclose(t2.round_loss, jres.round_loss[2:], atol=TOL)
    assert _maxdiff(t2.params, jres.params) <= TOL
    # port -> reference
    td = str(tmp_path)
    _run(tengine, olmo, "port", case, checkpointer=Checkpointer(td),
         ckpt_every=2)
    p, s, _ = tengine.restore_run(Checkpointer(td), ALGO, tcfg, tsfl, tp,
                                  tl.round_batch, step=1)
    jp2, js2, _ = jengine.restore_run(JCheckpointer(td), jalgo, jcfg, jsfl,
                                      jp, jl.round_batch, step=1)
    _assert_bit_equal(p, jp2)
    _assert_bit_equal(s, js2)
    j2 = jengine.run_rounds(jalgo, jcfg, jsfl, jp2, jl.round_batch, jsched,
                            jkey, rounds=ROUNDS, start_round=2, state=js2,
                            chunk_size=2, mode="async")
    np.testing.assert_allclose(j2.round_loss, jres.round_loss[2:], atol=TOL)


def _tiered():
    return ClientPopulation(cohorts=(
        Cohort(name="fast", n=3, delay=DelayModel(base=0.3, scale=0.0)),
        Cohort(name="slow", n=1, delay=DelayModel(base=1.0, scale=0.0))))


RESUMES = {
    # adaptive τ from 1 on a stationary tiered fleet: τ settles at
    # plan_tau(0.3 + 0.2 uplink, 0.1) by the checkpoint, and the
    # resumed prefix must be compiled with the τ=1 version it ran
    "dense-adaptive-tau": (dict(tau=1, quorum=3), lambda: tengine.AdaptiveTau(
        tau_max=8)),
    # adaptive quorum from K0=2 under heavy crashes (each crashed client
    # re-dispatched after 0.05 s): K falls to its floor 1, a fixed point,
    # by the checkpoint; the resumed prefix replays K0
    "sparse-adaptive-quorum": (dict(quorum=2, timeline="sparse",
                                    faults=dict(crash=0.9, backoff=0.05),
                                    quorum_timeout=1.0),
                               lambda: tengine.AdaptiveQuorum()),
}


@pytest.mark.parametrize("case", list(RESUMES))
def test_async_resume_is_bit_identical(olmo, tmp_path, case):
    """Versions 0-3 uninterrupted against 0-1 checkpointed and 2-3
    resumed through restore_run, apply_resume_overrides and the metadata's
    tau_per_version / quorum_per_version passed back as tau_history /
    quorum_history: losses, round times, τ, parameters and the store
    equal. Chunks of one version, so the controller decides before the
    checkpoint; a resumed run's first boundary observes no window."""
    extra, make_ctl = RESUMES[case]
    extra = dict(extra)
    plan = extra.pop("faults", None)
    kw = {**BASE, "perturbation_dist": "counter", "straggler_rate": 0.0,
          "participation": 1.0, "population": _tiered(), **extra}
    cfg, _, params, loader, _, key = _side(olmo, "port", BASE)
    sfl = TSFL(faults=plan and tfaults.FaultPlan(**plan), **kw)
    sched = tstrag.make_schedule(SEED, ROUNDS, population=kw["population"],
                                 t_server=0.1, t_comm=0.2)

    def run(**more):
        return tengine.run_rounds(ALGO, cfg, more.pop("sfl", sfl),
                                  more.pop("params", params),
                                  loader.round_batch, sched, key,
                                  rounds=ROUNDS, chunk_size=1, mode="async",
                                  telemetry=obs.TelemetrySink(), **more)

    ctl = make_ctl()
    full = run(controller=ctl)
    assert ctl.trace and len({t for _, t in ctl.trace}) == 1
    ck = Checkpointer(str(tmp_path))
    run(controller=make_ctl(), checkpointer=ck, ckpt_every=2)
    meta = read_meta(str(tmp_path), 1)
    md = meta["metadata"]
    ctl2 = make_ctl()
    sfl2 = tengine.apply_resume_overrides(sfl, meta, ctl2)
    if "quorum" in md["controller_overrides"]:
        assert md["quorum_per_version"][0] == 2 != sfl2.quorum
    else:
        assert md["tau_per_version"][0] == 1 != sfl2.tau
    p, s, meta = tengine.restore_run(ck, ALGO, cfg, sfl2, params,
                                     loader.round_batch, step=1)
    part2 = run(sfl=sfl2, params=p, state=s, start_round=2, controller=ctl2,
                tau_history=md["tau_per_version"],
                quorum_history=md["quorum_per_version"])
    assert np.array_equal(full.round_loss[2:], part2.round_loss)
    np.testing.assert_array_equal(full.round_times[2:], part2.round_times)
    np.testing.assert_array_equal(full.tau_per_round[2:],
                                  part2.tau_per_round)
    _assert_port_equal(part2.params, full.params)
    _assert_port_equal(part2.state, full.state)


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------

DRIVER_BASE = ["--arch", "olmo-1b", "--smoke", "--rounds", "1", "--clients",
               "4", "--batch", "1", "--seq", "16"]
BAD_ARGV = [
    ["--async", "--loop", "scan"], ["--async", "--algorithm", "gas"],
    ["--async", "--aggregation", "dense"], ["--quorum", "2"],
    ["--staleness-discount", "0.5"], ["--timeline", "sparse"],
    ["--faults", "crash=0.1"], ["--quorum-timeout", "1.0"],
    ["--adaptive-quorum"], ["--async", "--faults", "jitter=1"],
    ["--async", "--quorum-timeout", "-1"], ["--async", "--max-retries", "-1"],
    ["--async", "--adaptive-quorum"],
    ["--async", "--quorum", "2", "--adaptive-quorum", "--adaptive-tau"],
    ["--async", "--loader", "subset"], ["--async", "--quorum", "9"],
    ["--async", "--quorum", "5", "--population", "tiered:2x1.0,2x0.5"],
    ["--async", "--quorum", "2", "--staleness-discount", "1.5"],
    ["--async", "--quorum", "2", "--k-max", "-1"]]


def _driver_error(fn, capsys) -> str:
    with pytest.raises(SystemExit) as e:
        fn()
    err = capsys.readouterr().err.strip().splitlines()
    if isinstance(e.value.code, str):
        return e.value.code
    assert e.value.code == 2
    return err[-1].split("error: ", 1)[1]


def test_driver_argument_errors_match_reference(capsys):
    """Each bad combination of the semi-async and fault flags exits with
    the reference driver's message, before any round."""
    for argv in BAD_ARGV:
        want = _driver_error(lambda: j_train.main(DRIVER_BASE + argv), capsys)
        got = _driver_error(
            lambda: t_train.setup(DRIVER_BASE + argv + ["--device", "cpu"]),
            capsys)
        assert got == want, argv


KILL_ARGV = ["--smoke", "--device", "cpu", "--seq", "16", "--clients", "4",
             "--batch", "1", "--participation", "0.75", "--straggler-scale",
             "2.0", "--t-server", "0.5", "--t-comm", "0.2", "--rounds", "4",
             "--chunk-size", "2", "--ckpt-every", "2"]
KILLS = {
    "async-sparse-subset": ["--async", "--quorum", "2",
                            "--staleness-discount", "0.5", "--timeline",
                            "sparse", "--loader", "subset", "--quorum-timeout",
                            "1.0", "--telemetry"],
    "scan": ["--aggregation", "seed_replay"],
}
FAULTS = {"async-sparse-subset": "crash=0.2,loss=0.2,dup=0.1,corrupt=0.1",
          "scan": ""}


def _driver(tmp, tag, argv, kill=None):
    faults = ",".join(f for f in (FAULTS[tag.split(":")[0]],
                                  kill and f"kill={kill}") if f)
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *KILL_ARGV, *argv,
         *(["--faults", faults] if faults else []),
         "--ckpt-dir", str(tmp / "ck"), "--log-jsonl", str(tmp / "a.jsonl")],
        capture_output=True, text=True, timeout=300, cwd=str(ROOT),
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))


@pytest.mark.parametrize("case", list(KILLS))
def test_driver_sigkill_and_resume_is_bit_identical(tmp_path, case):
    """--faults kill=2 SIGKILLs the driver after the chunk [2, 4) flushed
    and before its checkpoint: only step 1 remains. The rerun without kill
    resumes from round 2, and its run log and final checkpoint (every
    params and store leaf) equal an uninterrupted run's."""
    argv = KILLS[case]
    killed = _driver(tmp_path, case, argv, kill=2)
    assert killed.returncode == -signal.SIGKILL, killed.stderr[-2000:]
    assert "[faults] kill=2: SIGKILL after chunk [2, 4)" in killed.stdout
    assert sorted(os.listdir(tmp_path / "ck")) == ["step_0000000001"]
    resumed = _driver(tmp_path, case, argv)
    assert resumed.returncode == 0, resumed.stderr[-2000:]
    assert "[resume] from round 2 (tau=2)" in resumed.stdout
    ref = tmp_path / "ref"
    ref.mkdir()
    faults = FAULTS[case]
    t_train.main([*KILL_ARGV, *argv, *(["--faults", faults] if faults
                                       else []),
                  "--ckpt-dir", str(ref / "ck"),
                  "--log-jsonl", str(ref / "a.jsonl")])
    rows = obs.read_jsonl(str(tmp_path / "a.jsonl"), kind="round")
    want = obs.read_jsonl(str(ref / "a.jsonl"), kind="round")
    assert [r["round"] for r in rows] == [0, 1, 2, 3]
    assert [r["loss"] for r in rows] == [r["loss"] for r in want]
    with np.load(tmp_path / "ck" / "step_0000000003" / "arrays.npz") as a, \
            np.load(ref / "ck" / "step_0000000003" / "arrays.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert any(k.startswith("state/") for k in a.files) == \
            case.startswith("async")
        for k in a.files:
            assert a[k].dtype == b[k].dtype and \
                a[k].tobytes() == b[k].tobytes(), k
