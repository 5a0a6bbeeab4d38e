"""Port parity: the observability layer (``repro_torch.obs``, copied whole
from ``repro.obs``) and its wiring into the synchronous engine and the
driver.

- The unit tests of ``tests/test_obs.py`` (span tracer, sink, metrics,
  run log, measure) run against both packages, and the outputs that can
  be compared are compared: the sink summary, run-log rows after a
  resume, the Chrome trace without its timestamps, metrics snapshots.
- The engine's two producers against the reference engine's on the same
  schedule: 'sim' records bit-identical to ChunkInfo.round_times and to
  the reference's (durations, per-cohort arrival) in both sync modes;
  one 'measured' record a segment; records across τ re-plans; the
  stage / dispatch / flush spans; nothing recorded and no clock read
  without a sink. 'python' mode calls back once a round, as the
  reference does, while the controller sees whole segments.
- AdaptiveTau's decisions and server-lr overrides identical to the
  reference's over ema, couple_lr, quantize and source.
- The driver's telemetry flags at SMOKE size on the CPU, against the
  reference's schedule, and its argument errors against the reference
  driver's.

Tolerances: host numpy values (durations, arrivals, masks, τ, simulated
clocks) exact; measured seconds are this machine's and only their
structure is checked.
"""
import json
import threading
import tracemalloc

import jax
import numpy as np
import pytest

from one_torch_thread import one_torch_thread  # noqa: F401
import repro.obs as jobs
import repro_torch.obs as tobs
from repro.configs import SFLConfig as JSFL
from repro.configs import get_config as j_get_config
from repro.core import engine as jengine
from repro.core import straggler as jstrag
from repro.launch import train as j_train
from repro.models import init_params as j_init
from repro.models import untie_params as j_untie
from repro_torch.configs import SFLConfig as TSFL
from repro_torch.configs import get_config as t_get_config
from repro_torch.core import engine as tengine
from repro_torch.core import prng
from repro_torch.core import straggler as tstrag
from repro_torch.launch import train as t_train
from repro_torch.models.convert import from_jax_params

PKGS = pytest.mark.parametrize("ob", [jobs, tobs], ids=["ref", "port"])


# ---------------------------------------------------------------------------
# unit tests of tests/test_obs.py, on both packages
# ---------------------------------------------------------------------------

@PKGS
def test_span_nesting_and_export_roundtrip(ob, tmp_path):
    tr = ob.SpanTracer()
    prev = ob.install(tr)
    try:
        with ob.span("outer", k=1):
            with ob.span("inner"):
                pass
            with ob.span("inner2") as s:
                s.set(rounds=8)
    finally:
        ob.install(prev)
    recs = {r.name: r for r in tr.records()}
    assert set(recs) == {"outer", "inner", "inner2"}
    assert recs["outer"].depth == 0
    assert recs["inner"].depth == recs["inner2"].depth == 1
    for child in ("inner", "inner2"):
        assert recs[child].start >= recs["outer"].start
        assert (recs[child].start + recs[child].duration
                <= recs["outer"].start + recs["outer"].duration + 1e-9)
    assert recs["outer"].attrs == {"k": 1}
    assert recs["inner2"].attrs == {"rounds": 8}
    jl = tmp_path / "t.jsonl"
    assert tr.export_jsonl(str(jl)) == 3
    rows = [json.loads(line) for line in jl.read_text().splitlines()]
    assert {r["name"] for r in rows} == {"outer", "inner", "inner2"}
    ct = tmp_path / "t.json"
    assert tr.export_chrome(str(ct)) == 3
    events = json.loads(ct.read_text())["traceEvents"]
    assert all(e["ph"] == "X" for e in events)


@PKGS
def test_no_or_disabled_tracer_is_null_span(ob):
    prev = ob.install(None)
    try:
        s1, s2 = ob.span("a", x=1), ob.span("b")
        assert s1 is s2 is ob.trace._NULL_SPAN
        with s1 as s:
            s.set(anything=0)
        tr = ob.SpanTracer(enabled=False)
        assert ob.install(tr) is None
        assert ob.get_tracer() is tr
        with ob.span("hot"):
            pass
    finally:
        ob.install(prev)
    assert tr.records() == []


@PKGS
def test_tracer_thread_safety(ob):
    tr = ob.SpanTracer()
    prev = ob.install(tr)

    def work(i):
        for _ in range(50):
            with ob.span("w", tid=i):
                pass
    try:
        ts = [threading.Thread(target=work, args=(i,)) for i in range(4)]
        [t.start() for t in ts]
        [t.join() for t in ts]
    finally:
        ob.install(prev)
    assert len(tr.records()) == 200
    assert {r.depth for r in tr.records()} == {0}


def _rec(ob, start, stop, source="sim", **kw):
    return ob.RoundTelemetry(start, stop, source, "scan",
                             np.arange(stop - start, dtype=np.float64), **kw)


@PKGS
def test_sink_ring_window_latest(ob):
    sink = ob.TelemetrySink(capacity=3)
    for i in range(5):
        sink.emit(_rec(ob, i * 2, i * 2 + 2))
    assert sink.emitted == 5 and len(sink.records()) == 3
    assert sink.records()[0].start == 4
    assert [(r.start, r.stop) for r in sink.window(5, 7)] == [(4, 6), (6, 8)]
    assert sink.window(100, 200) == ()
    assert sink.latest().start == 8 and sink.latest("measured") is None
    sink.clear()
    assert sink.records() == [] and sink.emitted == 5
    with pytest.raises(ValueError):
        ob.TelemetrySink(capacity=0)


@PKGS
def test_round_telemetry_json_and_stamp(ob):
    r = _rec(ob, 2, 5, quorum_wait=np.array([1.0, 2.0, 3.0]))
    j = r.to_json()
    assert j["durations"] == [0.0, 1.0, 2.0]
    assert j["quorum_wait"] == [1.0, 2.0, 3.0]
    assert j["cohort_arrival"] is None and r.n_rounds == 3
    json.dumps(j)
    sink = ob.TelemetrySink()
    sink.emit(r)
    assert sink.records()[0].t_wall > 0


@PKGS
def test_metrics_registry(ob):
    reg = ob.MetricsRegistry()
    reg.counter("c").inc()
    reg.counter("c").inc(4)
    reg.gauge("g").set(2.5)
    h = reg.histogram("h")
    for v in (0.001, 0.01, 0.01, 5.0):
        h.observe(v)
    snap = reg.snapshot()
    assert snap["c"]["value"] == 5 and snap["g"]["value"] == 2.5
    assert snap["h"]["count"] == 4
    assert snap["h"]["min"] == 0.001 and snap["h"]["max"] == 5.0
    assert h.quantile(0.5) >= 0.01
    with pytest.raises(TypeError):
        reg.gauge("c")
    with pytest.raises(ValueError):
        reg.counter("c").inc(-1)
    assert ob.get_registry() is ob.get_registry()


@PKGS
def test_runlog_and_partial_tail(ob, tmp_path):
    p = str(tmp_path / "run.jsonl")
    with ob.RunLog(p, log_every=2) as log:
        for r in range(6):
            log.round(r, loss=float(r))
        log.chunk(0, 4, telemetry=(_rec(ob, 0, 4),), extra=1)
    assert [r["round"] for r in ob.read_jsonl(p, kind="round")] == [0, 2, 4]
    with pytest.raises(ValueError):
        ob.RunLog(str(tmp_path / "x.jsonl"), log_every=0)
    q = tmp_path / "r.jsonl"
    q.write_text('{"kind": "round", "round": 0}\n{"kind": "rou')
    assert len(ob.read_jsonl(str(q))) == 1


@PKGS
def test_measure(ob):
    m = ob.measure(lambda n: bytes(n), 1 << 20)
    assert isinstance(m, ob.Measurement) and len(m.result) == 1 << 20
    assert m.seconds > 0 and m.peak_bytes >= 1 << 20
    with pytest.raises(SystemExit):
        ob.measure(lambda: (_ for _ in ()).throw(SystemExit(2)))
    assert not tracemalloc.is_tracing()


def _summary(ob, tmp_path):
    sink = ob.TelemetrySink()
    sink.emit(_rec(ob, 0, 4))
    sink.emit(_rec(ob, 0, 4, source="measured", dispatch_seconds=0.5,
                   staging_seconds=0.1, staging_bytes=1024))
    sink.emit(_rec(ob, 4, 6, quorum_wait=np.array([0.5, 1.5]), crashed=2,
                   started=4))
    return sink.summary()


def _runlog_rows(ob, tmp_path):
    p = str(tmp_path / f"{ob.__name__}.jsonl")
    with ob.RunLog(p, log_every=2) as log:
        for r in range(6):
            log.round(r, loss=float(r))
        log.chunk(0, 4, telemetry=(_rec(ob, 0, 4),), extra=1)
        log.chunk(4, 8, telemetry=())
    with ob.RunLog(p, resume_round=4) as log:
        log.round(4, loss=9.0)
    return ob.read_jsonl(p)


def _chrome(ob, tmp_path):
    tr = ob.SpanTracer()
    prev = ob.install(tr)
    try:
        with ob.span("engine.stage", start=0, stop=2):
            with ob.span("inner"):
                pass
        with ob.span("engine.dispatch", start=0, stop=2) as s:
            s.set(bytes=8)
    finally:
        ob.install(prev)
    p = str(tmp_path / f"{ob.__name__}.json")
    tr.export_chrome(p)
    trace = json.loads(open(p).read())
    for e in trace["traceEvents"]:
        del e["ts"], e["dur"]
    return trace


def _metrics(ob, tmp_path):
    reg = ob.MetricsRegistry()
    reg.counter("train.rounds").inc(4)
    reg.gauge("train.last_loss").set(5.5)
    h = reg.histogram("train.sim_round_seconds")
    for v in (2.5, 13.3, 7.5, 3.2, 1e-7, 1e3):
        h.observe(v)
    return reg.snapshot()


@pytest.mark.parametrize("output", [_summary, _runlog_rows, _chrome,
                                    _metrics],
                         ids=["summary", "runlog", "chrome", "metrics"])
def test_outputs_match_reference(output, tmp_path):
    assert output(tobs, tmp_path) == output(jobs, tmp_path)


# ---------------------------------------------------------------------------
# the engine's producers against the reference engine's
# ---------------------------------------------------------------------------

M, ROUNDS, CHUNK = 4, 5, 2
POP = "tiered:2x1.0@0.5,2x0.3%2.0"
TINY = dict(n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, d_ff=64,
            vocab_size=64, max_seq_len=64, dtype="float32")


@pytest.fixture(scope="module")
def tiny():
    jcfg = j_get_config("olmo-1b", smoke=True).replace(**TINY)
    tcfg = t_get_config("olmo-1b", smoke=True).replace(**TINY)
    params = j_untie(jcfg, j_init(jcfg, jax.random.PRNGKey(0)))
    return jcfg, tcfg, params, from_jax_params(params)


def batch_fn(r):
    t = np.random.default_rng(99 + r).integers(0, 64, (M, 2, 16))
    return {"tokens": t, "labels": t}


def _side(port, tiny, t_server=0.1, tau=2):
    jcfg, tcfg, jp, tp = tiny
    strag, SFL = (tstrag, TSFL) if port else (jstrag, JSFL)
    pop = strag.parse_population(POP, straggler_scale=1.0)
    sfl = SFL(n_clients=M, tau=tau, cut_units=1, lr_server=5e-3,
              lr_client=1e-3, population=pop)
    sched = strag.make_schedule(0, ROUNDS, population=pop, t_server=t_server,
                                t_comm=0.2)
    return ((tengine, tcfg, tp, prng.PRNGKey(0)) if port else
            (jengine, jcfg, jp, jax.random.PRNGKey(0))) + (sfl, sched)


def _run_with_sink(port, tiny, mode, controller=None, sink=True, **kw):
    eng, cfg, params, key, sfl, sched = _side(port, tiny, **kw)
    sink = (tobs if port else jobs).TelemetrySink() if sink else None
    infos = []
    res = eng.run_rounds("mu_splitfed", cfg, sfl, params, batch_fn, sched,
                         key, rounds=ROUNDS, mode=mode, chunk_size=CHUNK,
                         telemetry=sink, controller=controller,
                         chunk_callback=lambda i, p, s: infos.append(i))
    return res, sink, infos


@pytest.mark.parametrize("mode", ["scan", "python"])
def test_sim_telemetry_matches_chunkinfo_and_reference(tiny, mode):
    """The sim producer emits at every flush (once a chunk in 'scan',
    once a round in 'python') with durations bit-identical to
    ChunkInfo.round_times, and its records equal the reference engine's:
    windows, durations and per-cohort arrival latencies (two cohorts,
    one with a doubled uplink)."""
    _, tsink, tinfos = _run_with_sink(True, tiny, mode)
    _, jsink, _ = _run_with_sink(False, tiny, mode)
    tsims, jsims = tsink.records("sim"), jsink.records("sim")
    expected = ([(0, 2), (2, 4), (4, 5)] if mode == "scan"
                else [(r, r + 1) for r in range(ROUNDS)])
    assert [(r.start, r.stop) for r in tsims] == \
        [(i.start, i.stop) for i in tinfos] == expected == \
        [(r.start, r.stop) for r in jsims]
    for t, i, j in zip(tsims, tinfos, jsims):
        assert np.array_equal(t.durations, i.round_times)
        assert np.array_equal(t.durations, j.durations)
        assert t.cohort_arrival.shape == (2,)
        assert np.array_equal(t.cohort_arrival, j.cohort_arrival)
        assert t.quorum_wait is None and t.mode == j.mode == mode


@pytest.mark.parametrize("mode", ["scan", "python"])
def test_measured_telemetry_one_record_a_segment(tiny, mode):
    """One measured record per segment, whatever the flushes: dispatch
    seconds spread evenly over the segment's rounds; in 'scan' the staged
    host batches' bytes."""
    _, sink, _ = _run_with_sink(True, tiny, mode)
    meas = sink.records("measured")
    assert [(r.start, r.stop) for r in meas] == [(0, 2), (2, 4), (4, 5)]
    for r in meas:
        assert r.dispatch_seconds > 0 and r.mode == mode
        assert r.durations.shape == (r.n_rounds,)
        assert np.allclose(r.durations.sum(), r.dispatch_seconds)
        assert r.staging_bytes == (r.n_rounds * 2 * M * 2 * 16 * 8
                                   if mode == "scan" else 0)


def test_python_mode_calls_back_every_round(tiny):
    """The repair of 'python' mode: with chunks of 2, the callback gets
    one-round ChunkInfos, as the reference's does, and the controller's
    metrics at each boundary cover the whole previous segment."""
    seqs = {}
    for port in (False, True):
        eng = tengine if port else jengine
        seen = []

        class Probe(eng.AdaptiveTau):
            def update(self, round_idx, window, metrics):
                seen.append(None if metrics is None else
                            (metrics.start, metrics.stop,
                             metrics.masks.shape, len(metrics.round_loss)))
                return super().update(round_idx, window, metrics)

        _, _, infos = _run_with_sink(port, tiny, "python", Probe(tau_max=4),
                                     sink=False)
        seqs[port] = ([(i.start, i.stop) for i in infos], seen)
    assert seqs[True] == seqs[False]
    assert seqs[True][0] == [(r, r + 1) for r in range(ROUNDS)]
    assert seqs[True][1] == [None, (0, 2, (2, M), 2), (2, 4, (2, M), 2)]


def test_telemetry_survives_controller_replans(tiny):
    """AdaptiveTau on the measured clock re-plans τ (1 -> 4: the CPU's
    seconds a round over a 1 ms server step); the sink keeps every
    segment's records and each window after the first carries both
    producers'."""
    seen = []

    class Probe(tengine.AdaptiveTau):
        def update(self, round_idx, window, metrics):
            if window is not None:
                seen.append(window.telemetry)
            return super().update(round_idx, window, metrics)

    ctl = Probe(tau_max=4, source="measured")
    res, sink, _ = _run_with_sink(True, tiny, "scan", ctl, t_server=1e-3,
                                  tau=1)
    assert ctl.trace and list(res.tau_per_round) == [1, 1, 4, 4, 4]
    assert len(seen) == 2
    for w in seen:
        assert {r.source for r in w} == {"sim", "measured"}
    for src in ("sim", "measured"):
        covered = sorted((r.start, r.stop) for r in sink.records(src))
        assert covered[0][0] == 0 and covered[-1][1] == ROUNDS
        assert all(a[1] == b[0] for a, b in zip(covered, covered[1:]))


def test_engine_spans_cover_hot_path(tiny):
    tr = tobs.SpanTracer()
    prev = tobs.install(tr)
    try:
        _run_with_sink(True, tiny, "scan", sink=False)
    finally:
        tobs.install(prev)
    recs = tr.records()
    for want in ("engine.stage", "engine.dispatch", "engine.flush"):
        got = [r.attrs for r in recs if r.name == want]
        assert got == [{"start": 0, "stop": 2}, {"start": 2, "stop": 4},
                       {"start": 4, "stop": 5}], want
    assert {r.depth for r in recs} == {0}


def test_telemetry_off_emits_nothing_and_reads_no_clock(tiny, monkeypatch):
    """No sink and a disabled tracer: no record, no clock read, no extra
    synchronise (both replaced by functions that raise)."""
    def boom(*a):
        raise AssertionError("clock read or synchronise without a sink")

    monkeypatch.setattr(tengine, "perf_counter", boom)
    monkeypatch.setattr(tengine, "_synchronize", boom)
    tr = tobs.SpanTracer(enabled=False)
    prev = tobs.install(tr)
    try:
        for mode in ("scan", "python"):
            res, _, _ = _run_with_sink(True, tiny, mode, sink=False)
            assert res.round_loss.shape == (ROUNDS,)
        with pytest.raises(AssertionError, match="clock"):
            _run_with_sink(True, tiny, "scan")
    finally:
        tobs.install(prev)
    assert tr.records() == []


# ---------------------------------------------------------------------------
# AdaptiveTau against the reference's
# ---------------------------------------------------------------------------

def _windows(eng, ob):
    """Five boundaries: none, then windows with both producers' records,
    sim records only (the measured source falls back to the rows), two
    measured records, and no records at all."""
    rng = np.random.default_rng(5)

    def rows(p0, p1):
        return (rng.exponential(2.0, (p1 - p0, M)),
                (rng.random((p1 - p0, M)) < 0.7).astype(np.float32))

    def meas(p0, p1, secs):
        return ob.RoundTelemetry(p0, p1, "measured", "scan",
                                 np.full(p1 - p0, secs / (p1 - p0)),
                                 dispatch_seconds=secs)

    def sim(p0, p1):
        return ob.RoundTelemetry(p0, p1, "sim", "scan",
                                 rng.exponential(3.0, p1 - p0))

    out = [(0, None)]
    for p0, p1, tele in ((0, 2, lambda: (sim(0, 2), meas(0, 2, 3.3))),
                         (2, 4, lambda: (sim(2, 4),)),
                         (4, 6, lambda: (meas(4, 5, 0.9), meas(5, 6, 11.0))),
                         (6, 8, lambda: ())):
        d, m = rows(p0, p1)
        out.append((p1, eng.SchedWindow(p0, p1, d, m, 0.3, 0.2,
                                        telemetry=tele())))
    return out


@pytest.mark.parametrize("source", ["sim", "measured"])
@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("couple_lr", [True, False])
@pytest.mark.parametrize("ema", [0.5, 0.2])
def test_adaptive_tau_matches_reference(ema, couple_lr, quantize, source):
    """The same windows and synthetic records to both packages: the same
    decisions, server lr overrides and controller state; a controller
    restored from state_dict continues as the original does."""
    runs = {}
    for name, eng, ob, SFL in (("ref", jengine, jobs, JSFL),
                               ("port", tengine, tobs, TSFL)):
        kw = dict(tau_max=16, ema=ema, couple_lr=couple_lr,
                  quantize=quantize, source=source)
        ctl = eng.AdaptiveTau(**kw)
        ctl.bind(SFL(n_clients=M, tau=2, lr_server=1e-3))
        wins = _windows(eng, ob)
        outs = [ctl.update(r, w, None) for r, w in wins[:3]]
        fresh = eng.AdaptiveTau(**kw)
        fresh.load_state_dict(ctl.state_dict())
        rest = [(ctl.update(r, w, None), fresh.update(r, w, None))
                for r, w in wins[3:]]
        assert all(a == b for a, b in rest)
        runs[name] = (outs + [a for a, _ in rest], ctl.trace,
                      ctl.state_dict())
    assert runs["port"] == runs["ref"]
    assert len(runs["port"][1]) == 4
    assert all(("lr_server" in o) == couple_lr for o in runs["port"][0][1:])


def test_adaptive_tau_rejects_unknown_source():
    with pytest.raises(ValueError):
        tengine.AdaptiveTau(source="psychic")


# ---------------------------------------------------------------------------
# the driver's flags
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("algorithm", ["vanilla", "gas"])
def test_driver_telemetry_flags(algorithm, tmp_path):
    """--telemetry --log-jsonl --trace-out with adaptive τ on the measured
    clock at SMOKE size: the log's round rows carry the reference
    schedule's active counts and simulated clock, each chunk row both
    producers' records, the trace the engine's spans."""
    log, trace = str(tmp_path / "run.jsonl"), str(tmp_path / "trace.json")
    argv = ["--smoke", "--device", "cpu", "--rounds", "4", "--seq", "8",
            "--clients", "4", "--batch", "1", "--participation", "0.75",
            "--straggler-scale", "2.0", "--t-server", "0.5", "--t-gen",
            "0.3", "--t-comm", "0.2", "--adaptive-tau", "--tau-max", "4",
            "--chunk-size", "2", "--algorithm", algorithm, "--telemetry",
            "--tau-source", "measured", "--log-jsonl", log, "--trace-out",
            trace]
    run = t_train.setup(argv)
    lines = []
    res, ctl = t_train.run_engine(run, log=lines.append)
    assert ctl.trace and np.isfinite(res.round_loss).all()
    jsfl = JSFL(n_clients=4, participation=0.75, straggler_rate=2.0)
    js = jstrag.make_schedule(
        0, 4, population=jstrag.ClientPopulation.resolve(jsfl),
        t_server=0.5, t_gen=0.3, t_comm=0.2)
    clock, want = jstrag.WallClock(), []
    for r in range(4):
        d, m = js.delays[r], js.masks[r]
        dt = (jstrag.round_time_gas(d, m, 0.5, 0.3, js.comm_for(m))
              if algorithm == "gas" else
              jstrag.round_time_vanilla(d, m, 0.5, js.comm_for(m)))
        want.append([r, int((m > 0).sum()), clock.tick(dt)])
    rows = tobs.read_jsonl(log, kind="round")
    assert [[r["round"], r["active"], r["sim_t"]] for r in rows] == want
    chunks = tobs.read_jsonl(log, kind="chunk")
    assert [(c["start"], c["stop"]) for c in chunks] == [(0, 2), (2, 4)]
    for c in chunks:
        assert sorted(t["source"] for t in c["telemetry"]) == \
            ["measured", "sim"]
    names = [e["name"] for e in json.load(open(trace))["traceEvents"]]
    assert names.count("engine.dispatch") == 2
    assert "telemetry summary:" in lines and "metrics:" in lines
    assert lines[0].split("active ")[1].split()[0] == f"{want[0][1]}/4"


@pytest.mark.parametrize("bad", [["--tau-source", "measured"],
                                 ["--log-every", "0"]],
                         ids=["measured-without-adaptive", "log-every"])
def test_driver_argument_errors_match_reference(bad, capsys):
    with pytest.raises(SystemExit) as ref:
        j_train.main(["--smoke", "--rounds", "1", "--seq", "8", *bad])
    ref_err = capsys.readouterr().err.strip().splitlines()[-1]
    with pytest.raises(SystemExit) as port:
        t_train.setup(["--smoke", "--device", "cpu", "--rounds", "1",
                       "--seq", "8", *bad])
    port_err = capsys.readouterr().err.strip().splitlines()[-1]
    assert ref.value.code == port.value.code == 2
    assert port_err == ref_err and "error:" in port_err
