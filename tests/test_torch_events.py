"""Port parity: the semi-async timeline's host half and fault injection
(``repro_torch.core.events`` up to the record store, ``core.faults``) and
the loader's subset staging (``data.loader``) against the JAX package.

Everything here is host numpy on both sides, so every comparison is exact:
each ``Timeline`` field, each ``SparseRows`` field, every fault counter,
``parse_faults``'s plans and errors, ``record_checksum``,
``resolve_store_geometry``, ``quorum_round_time`` and the subset batches
are np.array_equal (or ==) to the reference's. The one departure is the
reference's sparse horizon fault (M=2, V=1, quorum=1, quorum_timeout=1.0):
the port's sparse timeline is held against the reference's dense one
there, and against its own dense one under random fault plans.
"""
import dataclasses

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from one_torch_thread import one_torch_thread  # noqa: F401
from repro.configs import SFLConfig as JSFL
from repro.core import events as jev
from repro.core import faults as jfaults
from repro.core import straggler as jstrag
from repro.core.population import ClientPopulation as JPop
from repro.core.population import Cohort as JCohort
from repro.core.population import DelayModel as JDelay
from repro.data import FederatedLoader as JLoader
from repro.data import SyntheticLM as JSynthetic
from repro.data import dirichlet_partition as j_partition
from repro_torch.configs import SFLConfig as TSFL
from repro_torch.core import events as tev
from repro_torch.core import faults as tfaults
from repro_torch.core import straggler as tstrag
from repro_torch.core.population import ClientPopulation as TPop
from repro_torch.core.population import Cohort as TCohort
from repro_torch.core.population import DelayModel as TDelay
from repro_torch.data import FederatedLoader as TLoader
from repro_torch.data import SyntheticLM as TSynthetic
from repro_torch.data import dirichlet_partition as t_partition

M, V = 6, 10
PLANS = [dict(crash=0.3), dict(loss=0.4), dict(corrupt=0.3, dup=0.3),
         dict(crash=0.2, loss=0.2, dup=0.2, corrupt=0.2, backoff=0.25)]


def _pops(kind):
    """(reference population, port population) or (None, None)."""
    if kind == "tiered":
        spec = [("fast", 4, dict(base=0.3, scale=0.0), {}),
                ("slow", 2, dict(base=2.0, scale=0.0), {})]
    elif kind == "markov":
        spec = [("a", 3, dict(base=0.5, scale=0.5),
                 dict(availability="markov", p_dropout=0.3, p_recover=0.5)),
                ("b", 3, dict(base=1.5, scale=0.2),
                 dict(availability="markov-shared", p_dropout=0.2,
                      p_recover=0.6, participation=0.8))]
    else:
        return None, None
    return tuple(
        pop(cohorts=tuple(cohort(name=n, n=k, delay=delay(**d), **kw)
                          for n, k, d, kw in spec))
        for pop, cohort, delay in ((JPop, JCohort, JDelay),
                                   (TPop, TCohort, TDelay)))


def _scheds(pop="scalar", seed=0, rounds=12, m=M, **kw):
    """The same schedule drawn by each package: (reference, port)."""
    jp, tp = _pops(pop)
    kw.setdefault("t_server", 0.1)
    kw.setdefault("t_comm", 0.1)
    if jp is None:
        kw.setdefault("straggler_scale", 1.0)
        kw.setdefault("participation", 0.8)
        return (jstrag.make_schedule(seed, rounds, m, **kw),
                tstrag.make_schedule(seed, rounds, m, **kw))
    return (jstrag.make_schedule(seed, rounds, population=jp, **kw),
            tstrag.make_schedule(seed, rounds, population=tp, **kw))


def _plans(plan):
    """The same FaultPlan in each package (None stays None)."""
    if plan is None:
        return None, None
    return jfaults.FaultPlan(**plan), tfaults.FaultPlan(**plan)


def _assert_same(got, want, names=None):
    """Every named field (default: all of a Timeline's) equal."""
    names = names or [f.name for f in dataclasses.fields(jev.Timeline)]
    for f in names:
        x, y = getattr(got, f), getattr(want, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert np.array_equal(np.asarray(x), np.asarray(y)), f
            assert np.asarray(x).dtype == np.asarray(y).dtype, f


# ---------------------------------------------------------------------------
# the dense compiler and the sparse DES, field for field
# ---------------------------------------------------------------------------

GRID = [
    dict(quorum=0, discount=1.0),
    dict(quorum=3, discount=1.0),
    dict(quorum=3, discount=0.5),
    dict(quorum=2, discount=0.25, tau=[1, 2, 3, 1, 2, 3, 1, 2, 3, 1]),
    dict(quorum=[4, 4, 3, 3, 2, 2, 1, 1, 2, 2], discount=0.5),
    dict(quorum=2, discount=0.5, deadline=1.0),
    dict(quorum=2, discount=0.5, pop="tiered"),
    dict(quorum=3, discount=0.5, pop="markov"),
    dict(quorum=3, discount=0.5, quorum_timeout=0.3),
] + [dict(quorum=3, discount=0.5, plan=p, quorum_timeout=1.0)
     for p in PLANS] + [
    dict(quorum=3, discount=0.5, plan=PLANS[1], quorum_timeout=2.0,
         max_retries=1),
    dict(quorum=2, discount=0.5, plan=PLANS[3], quorum_timeout=0.5,
         pop="tiered"),
]


def _compile_both(case, sparse=False):
    """(reference, port) timelines of one GRID case."""
    case = dict(case)
    pop, plan = case.pop("pop", "scalar"), case.pop("plan", None)
    deadline = case.pop("deadline", None)
    js, ts = _scheds(pop)
    kw = dict(tau=case.pop("tau", 2), **case)
    if deadline is not None:     # deadline mask rows, as a controller's
        kw["mask_rows"] = np.stack(
            [js.participation[v % js.n_rounds]
             * jstrag.deadline_mask(js.delays[v % js.n_rounds], deadline)
             for v in range(V)])
    jp, tp = _plans(plan)
    if sparse:
        return (jev.compile_sparse_timeline(js, V, faults=jp, **kw),
                tev.compile_sparse_timeline(ts, V, faults=tp, **kw))
    return (jev.compile_timeline(js, V, faults=jp, **kw),
            tev.compile_timeline(ts, V, faults=tp, **kw))


@pytest.mark.parametrize("case", GRID, ids=range(len(GRID)))
def test_timeline_matches_reference(case):
    """Every Timeline field of compile_timeline bit-exact with the
    reference's: quorum (scalar and per version), discount, per-version
    τ, deadline mask rows, tiered and Markov fleets, each fault plan with
    quorum_timeout and max_retries."""
    want, got = _compile_both(case)
    _assert_same(got, want)
    assert got.quorum == want.quorum and got.discount == want.discount


@pytest.mark.parametrize("case", GRID, ids=range(len(GRID)))
def test_sparse_timeline_matches_reference(case):
    """compile_sparse_timeline's rows and its densify() bit-exact with the
    reference's, and equal to the port's own dense compiler."""
    want, got = _compile_both(case, sparse=True)
    _assert_same(got.rows, want.rows, list(jev.SparseRows._fields))
    _assert_same(got.densify(), want.densify())
    _assert_same(got.densify(), _compile_both(case)[1])


@pytest.mark.parametrize("plan", [None, PLANS[3]])
def test_stream_take_and_skip_match_reference(plan):
    """TimelineStream: chunked take() rows, and skip(r0) then take(), equal
    to the reference stream's, under a tight ring (k_max 3, capacity 4)
    that evicts and skips, and per-version τ and quorum arrays."""
    js, ts = _scheds("tiered")
    jp, tp = _plans(plan)
    taus = np.array([2, 2, 3, 3, 1, 1, 2, 2, 3, 3, 2, 2])
    quorums = np.array([3, 3, 2, 2, 2, 1, 1, 2, 2, 3, 3, 3])
    kw = dict(quorum=3, discount=0.5, taus=taus, k_max=3, capacity=4,
              quorums=quorums, quorum_timeout=0.6)
    for skip in (0, 5):
        a = jev.TimelineStream(js, 12, faults=jp, **kw)
        b = tev.TimelineStream(ts, 12, faults=tp, **kw)
        a.skip(skip)
        b.skip(skip)
        for n in (3, 4, 12):
            _assert_same(b.take(n), a.take(n), list(jev.SparseRows._fields))
        assert a.v == b.v == 12
    rows = tev.TimelineStream(ts, 12, faults=tp, **kw).take(12)
    assert rows.evicted.sum() + rows.skipped.sum() > 0


def test_stream_runs_on_lazy_schedules():
    """The sparse DES over a lazy SparseSchedule (AvailRows and keyed
    delays, never densified) takes the reference's rows."""
    jp, tp = _pops("markov")
    a = jev.TimelineStream(
        jstrag.make_sparse_schedule(3, 8, population=jp, t_server=0.2,
                                    t_comm=0.05), 10, quorum=2,
        discount=0.5, taus=2, k_max=4, capacity=6)
    b = tev.TimelineStream(
        tstrag.make_sparse_schedule(3, 8, population=tp, t_server=0.2,
                                    t_comm=0.05), 10, quorum=2,
        discount=0.5, taus=2, k_max=4, capacity=6)
    _assert_same(b.take(10), a.take(10), list(jev.SparseRows._fields))


def test_zero_fault_plan_is_bit_exact():
    """FaultPlan.none() (and a kill-only plan) leave both timelines
    bit-identical to faults=None (the reference's zero-fault contract)."""
    _, ts = _scheds()
    kw = dict(quorum=3, discount=0.5, tau=2)
    clean = tev.compile_timeline(ts, V, **kw)
    for plan in (tfaults.FaultPlan.none(), tfaults.FaultPlan(kill_round=3)):
        _assert_same(tev.compile_timeline(ts, V, faults=plan, **kw), clean)
        _assert_same(tev.compile_sparse_timeline(ts, V, faults=plan,
                                                 **kw).densify(), clean)


def test_stall_is_diagnosed_as_the_reference_does():
    """A fleet whose every dispatch crashes: QuorumStallError on both
    timelines without a timeout (the reference's message), finite commits
    with one."""
    js, ts = _scheds(m=3, rounds=8)
    kw = dict(quorum=2, discount=0.5, tau=2)
    jp, tp = _plans(dict(crash=1.0))
    with pytest.raises(jev.QuorumStallError) as want:
        jev.compile_timeline(js, 6, faults=jp, **kw)
    for fn in (tev.compile_timeline, tev.compile_sparse_timeline):
        with pytest.raises(tev.QuorumStallError) as got:
            fn(ts, 6, faults=tp, **kw)
        assert str(got.value) == str(want.value)
    _assert_same(tev.compile_timeline(ts, 6, faults=tp, quorum_timeout=0.5,
                                      **kw),
                 jev.compile_timeline(js, 6, faults=jp, quorum_timeout=0.5,
                                      **kw))


def test_sparse_horizon_follows_the_dense_compiler():
    """The reference's sparse fault (ROADMAP queue 3): M=2, V=1, quorum=1,
    quorum_timeout=1.0, a zero-fault plan, both arrivals after the
    deadline. The reference's dense compiler keeps both in flight
    (commit_idx -1); its sparse densify() returns no event. The port's
    sparse timeline equals the reference's dense one."""
    kw = dict(straggler_scale=0.0, participation=1.0, t_server=0.1,
              t_comm=0.05)
    js, ts = _scheds(m=2, rounds=4, **kw)
    args = dict(quorum=1, discount=1.0, tau=2, quorum_timeout=1.0)
    want = jev.compile_timeline(js, 1, faults=jfaults.FaultPlan.none(),
                                **args)
    assert want.n_events == 2 and np.all(want.commit_idx == -1)
    assert jev.compile_sparse_timeline(
        js, 1, faults=jfaults.FaultPlan.none(), **args).densify() \
        .n_events == 0
    got = tev.compile_sparse_timeline(ts, 1, faults=tfaults.FaultPlan.none(),
                                      **args).densify()
    _assert_same(got, want)


DYADIC = st.sampled_from([1.0, 0.5, 0.25])
FAULT_FLEET = st.fixed_dictionaries(dict(
    seed=st.integers(0, 2**31 - 1),
    M=st.integers(2, 10),
    V=st.integers(0, 16),
    quorum=st.integers(1, 10),
    timeout=st.floats(0.2, 2.0, allow_nan=False),
    discount=DYADIC,
    scale=st.floats(0.0, 3.0, allow_nan=False),
    part=st.floats(0.3, 1.0, allow_nan=False),
    t_server=st.floats(0.01, 1.0, allow_nan=False),
    plan=st.fixed_dictionaries(dict(
        crash=st.floats(0.0, 0.8, allow_nan=False),
        loss=st.floats(0.0, 0.8, allow_nan=False),
        dup=st.floats(0.0, 1.0, allow_nan=False),
        corrupt=st.floats(0.0, 0.8, allow_nan=False),
        backoff=st.floats(0.05, 1.0, allow_nan=False))),
))


@settings(database=None, max_examples=20, deadline=None)
@given(p=FAULT_FLEET)
def test_sparse_equals_dense_under_random_fault_plans(p):
    """The property the reference's own sparse DES fails
    (tests/test_timeline_property.py): under any FaultPlan with a
    quorum_timeout, the port's sparse timeline densifies to its dense
    compiler field for field, fault columns included, and the port's
    dense compiler equals the reference's."""
    q = min(p["quorum"], p["M"])
    kw = dict(straggler_scale=p["scale"], participation=p["part"],
              t_server=p["t_server"], t_comm=0.05)
    js, ts = _scheds(seed=p["seed"], rounds=4, m=p["M"], **kw)
    jp, tp = _plans(p["plan"])
    args = dict(quorum=q, discount=p["discount"], tau=2,
                quorum_timeout=p["timeout"])
    dense = tev.compile_timeline(ts, p["V"], faults=tp, **args)
    _assert_same(dense, jev.compile_timeline(js, p["V"], faults=jp, **args))
    _assert_same(tev.compile_sparse_timeline(ts, p["V"], faults=tp,
                                             **args).densify(), dense)


# ---------------------------------------------------------------------------
# faults.py and the geometry / time helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [
    "faults:crash=0.2,loss=0.1,dup=0.05,corrupt=0.01,backoff=0.25,kill=6",
    "crash=0.05,crash@slow=0.4", "", "kill=3", " loss=0.5 , ,dup=1"])
def test_parse_faults_matches_reference(spec):
    a, b = jfaults.parse_faults(spec), tfaults.parse_faults(spec)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert a.describe() == b.describe() and a.any() == b.any()


@pytest.mark.parametrize("spec", ["crash", "jitter=0.5", "backoff@slow=1.0",
                                  "crash=1.5", "backoff=-1", "kill=x"])
def test_parse_faults_errors_match_reference(spec):
    with pytest.raises(ValueError) as want:
        jfaults.parse_faults(spec)
    with pytest.raises(ValueError) as got:
        tfaults.parse_faults(spec)
    assert str(got.value) == str(want.value)


def test_resolve_and_dispatch_fates_match_reference():
    """Per-cohort overrides resolve to the same rate vectors, the same
    errors, and dispatch_fates draws the same fates."""
    jp, tp = _pops("tiered")
    plan = dict(crash=0.2, loss=0.3, overrides=(("corrupt", "slow", 0.9),))
    a = jfaults.FaultPlan(**plan).resolve(6, jp, seed=5)
    b = tfaults.FaultPlan(**plan).resolve(6, tp, seed=5)
    ids = np.arange(6)
    streaks = np.array([0, 1, 2, 0, 3, 1])
    for v in range(4):
        fa = a.dispatch_fates(v, ids, 1.5, np.linspace(0.1, 1.0, 6),
                              np.full(6, 0.2), streaks, 2)
        fb = b.dispatch_fates(v, ids, 1.5, np.linspace(0.1, 1.0, 6),
                              np.full(6, 0.2), streaks, 2)
        for k in fa:
            assert np.array_equal(fa[k], fb[k]) and \
                fa[k].dtype == fb[k].dtype, k
    for bad, pop in ((dict(overrides=(("crash", "slow", 1.0),)), None),
                     (dict(overrides=(("crash", "nope", 1.0),)), 1)):
        with pytest.raises(ValueError) as want:
            jfaults.FaultPlan(**bad).resolve(6, jp if pop else None)
        with pytest.raises(ValueError) as got:
            tfaults.FaultPlan(**bad).resolve(6, tp if pop else None)
        assert str(got.value) == str(want.value)


def test_record_checksum_matches_reference():
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 2**32, (4, 2, 1, 2), dtype=np.uint32)
    coeffs = rng.standard_normal((4, 2, 1)).astype(np.float32)
    assert tfaults.record_checksum(keys, coeffs) == \
        jfaults.record_checksum(keys, coeffs)
    flipped = coeffs.copy()
    flipped[1, 1, 0] = np.nextafter(flipped[1, 1, 0], 9.0, dtype=np.float32)
    assert tfaults.record_checksum(keys, flipped) != \
        tfaults.record_checksum(keys, coeffs)


@pytest.mark.parametrize("kw", [dict(M=7), dict(M=4, quorum=2),
                                dict(M=10_000, quorum=64),
                                dict(M=10_000, quorum=2, k_max=40),
                                dict(M=50, quorum=3, ring_capacity=5),
                                dict(M=50, k_max=80, ring_capacity=2)])
def test_resolve_store_geometry_matches_reference(kw):
    kw = dict(kw)
    m = kw.pop("M")
    assert tev.resolve_store_geometry(TSFL(n_clients=m, **kw)) == \
        jev.resolve_store_geometry(JSFL(n_clients=m, **kw))


@pytest.mark.parametrize("quorum", [0, 1, 3, 9])
def test_quorum_round_time_matches_reference(quorum):
    rng = np.random.default_rng(quorum)
    delays = rng.exponential(1.0, 6)
    mask = (rng.random(6) < 0.7).astype(np.float32)
    scale = rng.uniform(0.5, 2.0, 6)
    for t_comm_scale in (None, scale):
        args = (delays, mask, 0.25, 3)
        kw = dict(quorum=quorum, t_comm=0.1, t_comm_scale=t_comm_scale)
        assert tev.quorum_round_time(*args, **kw) == \
            jev.quorum_round_time(*args, **kw)


# ---------------------------------------------------------------------------
# the loader's subset staging
# ---------------------------------------------------------------------------

def test_subset_batch_is_bit_exact():
    """subset_batch(r, ids) equals round_batch(r)[ids] (pads re-read
    client 0) and the reference loader's subset_batch, with an empty
    client pool falling back to the union."""
    labels = np.arange(256) % 10
    parts = t_partition(labels, 8, alpha=0.5, seed=0)
    parts[5] = np.zeros(0, np.int64)
    tl = TLoader(TSynthetic(97, 16, 0), parts, 2, seed=0)
    jl = JLoader(JSynthetic(97, 16, 0),
                 [p.copy() for p in j_partition(labels, 8, alpha=0.5,
                                                seed=0)], 2, seed=0)
    jl.client_indices[5] = np.zeros(0, np.int64)
    for r in (0, 3):
        full = tl.round_batch(r)
        for ids in ([5, 0, 7], [0, 0, 0], list(range(8))[::-1]):
            sub = tl.subset_batch(r, np.asarray(ids))
            want = jl.subset_batch(r, np.asarray(ids))
            for k in full:
                assert np.array_equal(sub[k], full[k][ids])
                assert np.array_equal(sub[k], want[k])
                assert sub[k].dtype == want[k].dtype
