"""Port parity: checkpoints and resume (``repro_torch.ckpt``, the engine's
start_round / state / checkpointer, ``restore_run``,
``apply_resume_overrides``, the deadline override and the driver's
--ckpt-dir / --ckpt-every) against the JAX package, on the CPU.

Tolerances. Checkpoints are exact both ways: the same npz keys, dtype
names and checksums, and every restored leaf bit-equal (integer token
buffers equal in value: the reference holds them as int32, the port's
device batches as int64). A resumed port run is bit-identical to an
uninterrupted port run (losses np.array_equal, leaves torch.equal). The
port against the reference: masks, simulated round times, τ, controller
overrides and EMA exact; losses and parameters within 1e-4 (the repo's
f32 round tolerance on the f32 olmo-1b SMOKE model).
"""
import json
import os
import zipfile

import jax
import numpy as np
import pytest
import torch

from one_torch_thread import one_torch_thread  # noqa: F401
from repro.ckpt import Checkpointer as JCheckpointer
from repro.ckpt import restore_params as j_restore
from repro.ckpt import save_params as j_save
from repro.ckpt import verify_checkpoint as j_verify
from repro.ckpt.checkpoint import _leafkey_order
from repro.configs import SFLConfig as JSFL
from repro.configs import get_config as j_get_config
from repro.core import engine as jengine
from repro.core import straggler as jstrag
from repro.data import FederatedLoader as JLoader
from repro.data import SyntheticLM as JSynthetic
from repro.data import dirichlet_partition as j_partition
from repro.models import init_params as j_init
from repro.models import untie_params as j_untie
from repro_torch import obs
from repro_torch.ckpt import (Checkpointer, CorruptCheckpointError,
                              latest_good_step, latest_step, read_meta,
                              restore_params, save_params, verify_checkpoint)
from repro_torch.configs import SFLConfig as TSFL
from repro_torch.configs import get_config as t_get_config
from repro_torch.core import engine as tengine
from repro_torch.core import prng
from repro_torch.core import straggler as tstrag
from repro_torch.data import FederatedLoader as TLoader
from repro_torch.data import SyntheticLM as TSynthetic
from repro_torch.data import dirichlet_partition as t_partition
from repro_torch.launch import train as t_train
from repro_torch.models.convert import from_jax_params
from repro_torch.utils import tree

TOL = 1e-4
M, SEED = 3, 0
SFL_KW = dict(n_clients=M, tau=2, n_perturbations=1, cut_units=2,
              participation=0.67, straggler_rate=2.0)
ALGOS = {"mu_splitfed": {"aggregation": "dense"},
         "gas": {"aggregation": "seed_replay"}, "fedlora": {}}


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _host(x):
    """(array as stored, dtype name): bf16 as its uint16 bits."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        x = x.numpy()
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16), "bfloat16"
    return a, str(a.dtype)


def _assert_bit_equal(port_tree, jax_tree):
    """The port tree and the reference tree: the same leaf keys in the same
    order, and each leaf bit-equal (integer leaves equal in value)."""
    got = tree.path_leaves(port_tree)
    want = jax.tree_util.tree_flatten_with_path(jax_tree)[0]
    assert [k for k, _ in got] == _leafkey_order(jax_tree)
    for (k, a), (_, b) in zip(got, want):
        (x, dx), (y, dy) = _host(a), _host(b)
        assert x.shape == y.shape, k
        if x.dtype.kind in "iu" and y.dtype.kind in "iu" and "bfloat16" \
                not in (dx, dy):
            assert np.array_equal(x, y), k
        else:
            assert dx == dy and x.tobytes() == y.tobytes(), k


def _assert_port_equal(got, want):
    a, b = tree.path_leaves(got), tree.path_leaves(want)
    assert [k for k, _ in a] == [k for k, _ in b]
    for (k, x), (_, y) in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y), k


def _maxdiff(port_tree, jax_tree) -> float:
    got = [a.float().numpy() for _, a in tree.path_leaves(port_tree)]
    want = [np.asarray(b, np.float32)
            for b in jax.tree_util.tree_leaves(jax_tree)]
    assert len(got) == len(want)
    return max(float(np.abs(a - b).max()) for a, b in zip(got, want))


def _npz_keys(d, step):
    with np.load(os.path.join(d, f"step_{step:010d}", "arrays.npz")) as z:
        return set(z.files)


def _meta(d, step):
    with open(os.path.join(d, f"step_{step:010d}", "meta.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def olmo():
    jcfg = j_get_config("olmo-1b", smoke=True).replace(dtype="float32")
    tcfg = t_get_config("olmo-1b", smoke=True).replace(dtype="float32")
    params = j_untie(jcfg, j_init(jcfg, jax.random.PRNGKey(0)))
    return jcfg, tcfg, params, from_jax_params(params)


def _side(olmo, side, sfl_kw=SFL_KW, rounds=4, **sched_kw):
    """(engine, cfg, sfl, params, loader, schedule, key) of one package."""
    jcfg, tcfg, jp, tp = olmo
    parts = dict(labels=np.arange(256) % 10, n_clients=sfl_kw["n_clients"],
                 alpha=0.5, seed=SEED)
    sched_kw = sched_kw or dict(t_server=0.5, t_gen=0.3, t_comm=0.2)
    if side == "ref":
        sfl = JSFL(**sfl_kw)
        return (jengine, jcfg, sfl, jp,
                JLoader(JSynthetic(jcfg.vocab_size, 16, SEED),
                        j_partition(**parts), 1, seed=SEED),
                jstrag.make_schedule(
                    SEED, rounds,
                    population=jstrag.ClientPopulation.resolve(sfl),
                    **sched_kw),
                jax.random.PRNGKey(SEED))
    sfl = TSFL(**sfl_kw)
    return (tengine, tcfg, sfl, tp,
            TLoader(TSynthetic(tcfg.vocab_size, 16, SEED),
                    t_partition(**parts), 1, seed=SEED),
            tstrag.make_schedule(
                SEED, rounds, population=tstrag.ClientPopulation.resolve(sfl),
                **sched_kw),
            prng.PRNGKey(SEED))


def _port_run(olmo, algorithm, rounds, mode="scan", chunk_size=2, **kw):
    eng, cfg, sfl, params, loader, sched, key = _side(olmo, "port")
    return eng.run_rounds(algorithm, cfg, sfl, kw.pop("params", params),
                          loader.round_batch, sched, key, rounds=rounds,
                          chunk_size=chunk_size, mode=mode,
                          **ALGOS[algorithm], **kw)


@pytest.fixture(scope="module")
def ref_runs(olmo, tmp_path_factory):
    """The reference's checkpointed run of rounds 0-1 and its resume for
    rounds 2-3, once per algorithm (one algorithm instance, so one jit
    compile): (checkpoint dir, part 1, part 2, algorithm)."""
    cache = {}

    def get(algorithm):
        if algorithm not in cache:
            eng, cfg, sfl, params, loader, sched, key = _side(olmo, "ref")
            algo = eng.get_algorithm(algorithm, **ALGOS[algorithm])
            d = str(tmp_path_factory.mktemp(f"ref_{algorithm}"))
            ck = JCheckpointer(d)
            part1 = eng.run_rounds(algo, cfg, sfl, params, loader.round_batch,
                                   sched, key, rounds=2, chunk_size=2,
                                   mode="python", checkpointer=ck,
                                   ckpt_every=2)
            p, s, meta = eng.restore_run(ck, algo, cfg, sfl, params,
                                         loader.round_batch)
            part2 = eng.run_rounds(algo, cfg, sfl, p, loader.round_batch,
                                   sched, key, rounds=4,
                                   start_round=meta["step"] + 1, state=s,
                                   chunk_size=2, mode="python")
            cache[algorithm] = (d, part1, part2, algo)
        return cache[algorithm]

    return get


# ---------------------------------------------------------------------------
# the checkpoint module
# ---------------------------------------------------------------------------

def _mixed_tree():
    gen = torch.Generator().manual_seed(3)
    return {"w": torch.randn(33, 17, generator=gen).to(torch.bfloat16),
            "b": {"f": torch.randn(9, generator=gen),
                  "i": torch.arange(-4, 8, dtype=torch.int32),
                  "s": torch.tensor(2.5)},
            "t": (torch.randn(2, 3, generator=gen)[:, ::2],)}


def test_round_trip_is_bit_exact(tmp_path):
    """bf16, f32, int32, 0-d and non-contiguous leaves: stored as the
    reference stores them (bf16 as uint16 bits under "bfloat16", numpy's
    dtype names) and restored bit-equal with their dtypes."""
    src = _mixed_tree()
    path = save_params(str(tmp_path), 7, src, metadata={"a": 1})
    assert os.path.basename(path) == "step_0000000007"
    meta = _meta(str(tmp_path), 7)
    assert meta["dtypes"] == {"w": "bfloat16", "b/f": "float32",
                              "b/i": "int32", "b/s": "float32",
                              "t/0": "float32"}
    assert meta["step"] == 7 and meta["metadata"] == {"a": 1}
    with np.load(os.path.join(path, "arrays.npz")) as z:
        assert z["w"].dtype == np.uint16
    got, meta2 = restore_params(str(tmp_path), src)
    assert meta2["checksum"] == meta["checksum"]
    assert isinstance(got["t"], tuple)
    _assert_port_equal(got, src)
    assert verify_checkpoint(str(tmp_path), 7)
    assert latest_step(str(tmp_path)) == 7


@pytest.mark.parametrize("arch", ["olmo-1b", "qwen3-14b"])
def test_params_cross_load_both_ways(tmp_path, arch):
    """The bf16 SMOKE parameters of olmo-1b and of qwen3-14b (RMSNorm,
    qk-norm), carried into the port by models/convert.py: the port's
    checkpoint restores and verifies under the reference, the reference's
    under the port, bit-exact; both packages write the same keys, dtype
    names and checksum."""
    cfg = j_get_config(arch, smoke=True)
    jp = j_untie(cfg, j_init(cfg, jax.random.PRNGKey(1)))
    tp = from_jax_params(jp)
    a, b = str(tmp_path / "port"), str(tmp_path / "ref")
    save_params(a, 0, tp)
    j_save(b, 0, jp)
    assert j_verify(a, 0) and verify_checkpoint(b, 0)
    ma, mb = _meta(a, 0), _meta(b, 0)
    assert ma["dtypes"] == mb["dtypes"] and ma["checksum"] == mb["checksum"]
    assert _npz_keys(a, 0) == _npz_keys(b, 0)
    got_j, _ = j_restore(a, jp)
    _assert_bit_equal(tp, got_j)
    got_t, _ = restore_params(b, tp)
    _assert_bit_equal(got_t, jp)


def test_gas_bundle_keys_are_the_references(olmo):
    """The engine's GAS bundle walks as jax walks it: dict keys sorted,
    GasState's fields as '.h_buffer' and '.label_buffer'."""
    jcfg, tcfg, jp, tp = olmo
    toks = np.random.default_rng(0).integers(0, jcfg.vocab_size, (M, 1, 16))
    jb = {"tokens": toks.astype(np.int32), "labels": toks.astype(np.int32)}
    tb = tengine.to_device_batch(jb, torch.device("cpu"))
    sfl = TSFL(**SFL_KW)
    ts = tengine.get_algorithm("gas").init_state(tcfg, sfl, tp, tb)
    js = jengine.get_algorithm("gas").init_state(
        jcfg, JSFL(**SFL_KW), jp, jax.tree.map(jax.numpy.asarray, jb))
    keys = [k for k, _ in tree.path_leaves({"params": tp, "state": ts})]
    assert keys == _leafkey_order({"params": jp, "state": js})
    assert "state/.h_buffer/h" in keys
    assert "state/.label_buffer/tokens" in keys


def test_corrupt_checkpoints_fall_back_or_raise(tmp_path):
    """The newest step's payload rewritten with one value changed (a valid
    npz): it fails verification, latest_good_step, read_meta and a restore
    with step=None fall back to the step before, and an explicit request
    raises CorruptCheckpointError on the checksum; a flipped byte and a
    truncated npz raise it as unreadable."""
    d = str(tmp_path)
    src = {"w": torch.arange(4000, dtype=torch.float32)}
    ck = Checkpointer(d)
    for s in (1, 2):
        ck.save(s, {"w": src["w"] * s})
    ck.wait()
    npz = os.path.join(d, "step_0000000002", "arrays.npz")
    bad = (src["w"] * 2).numpy()
    bad[1234] += 1.0
    np.savez(npz, w=bad)
    assert not verify_checkpoint(d, 2) and verify_checkpoint(d, 1)
    assert latest_step(d) == 2 and latest_good_step(d) == 1
    assert read_meta(d)["step"] == 1
    got, meta = ck.restore(src)
    assert meta["step"] == 1 and torch.equal(got["w"], src["w"])
    with pytest.raises(CorruptCheckpointError, match="checksum"):
        restore_params(d, src, step=2)
    with zipfile.ZipFile(npz) as z:
        info = z.getinfo("w.npy")
    with open(npz, "r+b") as f:        # a byte inside the payload
        f.seek(info.header_offset + info.compress_size // 2)
        byte = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([byte[0] ^ 0xFF]))
    with pytest.raises(CorruptCheckpointError, match="unreadable"):
        restore_params(d, src, step=2)
    with open(npz, "r+b") as f:
        f.truncate(100)
    with pytest.raises(CorruptCheckpointError, match="unreadable"):
        restore_params(d, src, step=2)
    assert latest_good_step(d) == 1
    with pytest.raises(AssertionError, match="ckpt shape"):
        restore_params(d, {"w": torch.zeros(3)}, step=1)
    with pytest.raises(FileNotFoundError):
        restore_params(str(tmp_path / "none"), src)


def test_keep_last_k_atomicity_and_snapshot(tmp_path):
    """keep=2 leaves the two newest steps, no tmp.* directory is left, a
    save holds the values of its moment although the tensor is written in
    place before the worker ends, and a worker's error surfaces on
    wait()."""
    d = str(tmp_path)
    w = torch.arange(10.0)
    ck = Checkpointer(d, keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, {"w": w * s})
    big = torch.zeros(1000, 1000)
    ck.save(5, {"w": big})
    big.fill_(7.0)                     # the worker may still be writing
    ck.wait()
    assert sorted(os.listdir(d)) == ["step_0000000004", "step_0000000005"]
    got, _ = ck.restore({"w": big}, step=5)
    assert float(got["w"].abs().max()) == 0.0
    got, _ = ck.restore({"w": w}, step=4)
    assert torch.equal(got["w"], w * 4)
    save_params(d, 6, {"w": torch.zeros(1000, 100)})
    assert not [x for x in os.listdir(d) if x.startswith("tmp.")]
    os.makedirs(os.path.join(d, "step_0000000009"))   # a file in the way
    open(os.path.join(d, "tmp.9.%d" % os.getpid()), "w").close()
    ck.save(9, {"w": w})
    with pytest.raises(OSError):
        ck.wait()


# ---------------------------------------------------------------------------
# cross-loads of engine checkpoints and resumed runs against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("algorithm", list(ALGOS))
def test_engine_checkpoints_cross_load_and_resume(olmo, ref_runs, tmp_path,
                                                  algorithm):
    """Each package's engine checkpoint after rounds 0-1 (params alone for
    MU-SplitFed, the {'params','state'} bundle for GAS and FedLoRA): the
    same npz keys and metadata; the reference's restores under the port's
    restore_run and the port's under the reference's, bit-equal to the
    run that wrote it, and verifies under both. The port's own resumed
    trajectory (rounds 0-1 checkpointed, 2-3 resumed) is within 1e-4 of
    the reference's resumed run, and so are the reference's rounds 2-3
    resumed from the port's checkpoint."""
    jd, j1, j2, jalgo = ref_runs(algorithm)
    td = str(tmp_path)
    t1 = _port_run(olmo, algorithm, 2, checkpointer=Checkpointer(td),
                   ckpt_every=2)
    assert _npz_keys(td, 1) == _npz_keys(jd, 1)
    tm, jm = _meta(td, 1), _meta(jd, 1)
    assert tm["metadata"]["has_state"] is jm["metadata"]["has_state"] is (
        algorithm != "mu_splitfed")
    assert set(tm["dtypes"]) == set(jm["dtypes"])
    assert verify_checkpoint(jd, 1) and j_verify(td, 1)
    # reference -> port
    eng, cfg, sfl, tp, tl, tsched, tkey = _side(olmo, "port")
    p, s, meta = tengine.restore_run(Checkpointer(jd), algorithm, cfg, sfl,
                                     tp, tl.round_batch, **ALGOS[algorithm])
    assert meta["step"] == 1
    _assert_bit_equal(p, j1.params)
    if algorithm == "mu_splitfed":
        assert s is None
    else:
        _assert_bit_equal(s, j1.state)
    # port -> reference
    _, jcfg, jsfl, jp, jl, jsched, jkey = _side(olmo, "ref")
    p, s, meta = jengine.restore_run(JCheckpointer(td), jalgo, jcfg, jsfl,
                                     jp, jl.round_batch)
    _assert_bit_equal(t1.params, p)
    if algorithm != "mu_splitfed":
        _assert_bit_equal(t1.state, s)
    j2x = jengine.run_rounds(jalgo, jcfg, jsfl, p, jl.round_batch, jsched,
                             jkey, rounds=4, start_round=2, state=s,
                             chunk_size=2, mode="python")
    np.testing.assert_allclose(j2x.round_loss, j2.round_loss, atol=TOL)
    # the port's resume against the reference's
    p, s, _ = tengine.restore_run(Checkpointer(td), algorithm, cfg, sfl, tp,
                                  tl.round_batch, **ALGOS[algorithm])
    t2 = _port_run(olmo, algorithm, 4, params=p, start_round=2, state=s)
    np.testing.assert_array_equal(t2.round_times, j2.round_times)
    np.testing.assert_allclose(np.concatenate([t1.round_loss,
                                               t2.round_loss]),
                               np.concatenate([j1.round_loss,
                                               j2.round_loss]), atol=TOL)
    assert _maxdiff(t2.params, j2.params) <= TOL
    if algorithm == "fedlora":
        assert _maxdiff(t2.state, j2.state) <= TOL


@pytest.mark.parametrize("mode", ["scan", "python"])
@pytest.mark.parametrize("algorithm", list(ALGOS))
def test_resume_is_bit_identical(olmo, tmp_path, algorithm, mode):
    """4 uninterrupted rounds against rounds 0-1 checkpointed (ckpt_every
    2) and rounds 2-3 resumed through restore_run and
    apply_resume_overrides: losses, parameters and the state equal.
    MU-SplitFed runs adaptive τ on the simulated clock in chunks of one
    round, so τ reaches its cap (2 -> 4 at round 1) before the checkpoint,
    as the reference's own resume test has it: the resumed run replays
    the override, and its first boundary, which observes no window (the
    reference's rule), keeps τ where the uninterrupted run re-plans it to
    the same cap."""
    adaptive = algorithm == "mu_splitfed"
    chunk = 1 if adaptive else 2

    def ctl():
        return tengine.AdaptiveTau(tau_max=4) if adaptive else None

    full = _port_run(olmo, algorithm, 4, mode=mode, chunk_size=chunk,
                     controller=ctl())
    ck = Checkpointer(str(tmp_path))
    part1 = _port_run(olmo, algorithm, 2, mode=mode, chunk_size=chunk,
                      controller=ctl(), checkpointer=ck, ckpt_every=2)
    _, cfg, sfl, tp, tl, _, _ = _side(olmo, "port")
    c2 = ctl()
    meta = read_meta(str(tmp_path))
    assert meta["step"] == 1
    sfl = tengine.apply_resume_overrides(sfl, meta, c2)
    p, s, meta = tengine.restore_run(ck, algorithm, cfg, sfl, tp,
                                     tl.round_batch, **ALGOS[algorithm])
    eng, _, _, _, _, sched, key = _side(olmo, "port")
    part2 = eng.run_rounds(algorithm, cfg, sfl, p, tl.round_batch, sched, key,
                           rounds=4, start_round=2, state=s, chunk_size=chunk,
                           mode=mode, controller=c2, **ALGOS[algorithm])
    if adaptive:
        assert meta["metadata"]["controller_overrides"]["tau"] == 4
        assert full.tau_per_round.tolist() == [2, 4, 4, 4]
        assert part2.tau_per_round.tolist() == [4, 4]
        assert c2.trace == [(3, 4)]
    assert np.array_equal(full.round_loss,
                          np.concatenate([part1.round_loss,
                                          part2.round_loss]))
    np.testing.assert_array_equal(full.round_times[2:], part2.round_times)
    _assert_port_equal(part2.params, full.params)
    if algorithm != "mu_splitfed":
        _assert_port_equal(part2.state, full.state)


def test_adaptive_tau_resume_replays_overrides_and_ema(olmo, tmp_path):
    """As tests/test_population.py's resume test, on both packages: a
    constant-delay fleet (base 2.0, t_server 0.25, so τ* = 8), τ 1 -> 8 at
    round 2; the checkpoint at round 3 records the same overrides (JSON
    values) and controller state; apply_resume_overrides gives the same τ,
    η_s (η_s·τ held) and EMA; the resumed rounds 4-7 run at τ 8 on both.
    On both, the first resumed boundary (round 4) observes no window and
    makes no decision, so the traces and the final EMA agree."""
    kw = dict(n_clients=4, tau=1, cut_units=1, lr_server=5e-3,
              lr_client=1e-3, lr_global=1.0)
    out = {}
    for side, Ck, strag, SFL in (("ref", JCheckpointer, jstrag, JSFL),
                                 ("port", Checkpointer, tstrag, TSFL)):
        pop = strag.ClientPopulation(cohorts=(strag.Cohort(
            name="all", n=4, delay=strag.DelayModel(base=2.0, scale=0.0)),))
        sfl_kw = dict(kw, population=pop)
        eng, cfg, sfl, params, loader, sched, key = _side(
            olmo, side, sfl_kw=sfl_kw, rounds=8, t_server=0.25)
        algo = eng.get_algorithm("mu_splitfed")
        d = str(tmp_path / side)
        ck = Ck(d)
        eng.run_rounds(algo, cfg, sfl, params, loader.round_batch, sched, key,
                       rounds=4, chunk_size=2, mode="python",
                       controller=eng.AdaptiveTau(tau_max=64),
                       checkpointer=ck, ckpt_every=2)
        p, s, meta = eng.restore_run(ck, algo, cfg, sfl, params,
                                     loader.round_batch)
        ctl2 = eng.AdaptiveTau(tau_max=64)
        sfl2 = eng.apply_resume_overrides(sfl, meta, ctl2)
        t_hat = ctl2.t_hat
        res = eng.run_rounds(algo, cfg, sfl2, p, loader.round_batch, sched,
                             key, rounds=8, start_round=meta["step"] + 1,
                             chunk_size=2, mode="python", controller=ctl2)
        out[side] = (s, _meta(d, 3), sfl2, t_hat, res,
                     (ctl2.trace, ctl2.t_hat))
    (js, jm, jsfl, jt, jres, jtrace), (ts, tm, tsfl, tt, tres, ttrace) = (
        out["ref"], out["port"])
    assert js is None and ts is None          # params-only checkpoints
    assert tm["metadata"]["controller_overrides"] == \
        jm["metadata"]["controller_overrides"] == {"tau": 8,
                                                   "lr_server": 5e-3 / 8}
    assert type(tm["metadata"]["controller_overrides"]["tau"]) is int
    assert tm["metadata"]["controller_state"] == \
        jm["metadata"]["controller_state"]
    assert (tsfl.tau, tsfl.lr_server) == (jsfl.tau, jsfl.lr_server)
    assert tt == jt == 2.0
    assert tres.tau_per_round.tolist() == jres.tau_per_round.tolist() == \
        [8] * 4
    np.testing.assert_array_equal(tres.round_times, jres.round_times)
    np.testing.assert_allclose(tres.round_loss, jres.round_loss, atol=TOL)
    assert ttrace == jtrace == ([(6, 8)], 2.0)


def test_deadline_override_matches_reference(olmo, tmp_path):
    """As tests/test_population.py's deadline test, on both packages: a
    controller that returns deadline 2.0 at every boundary drops the
    base-9 tier from round 0 on; the consumed masks and simulated round
    times equal the reference's exactly, losses within 1e-4, and the
    checkpoint records the override. The port resumes rounds 4-5 from the
    checkpoint at round 3 on a schedule drawn without the deadline: the
    restored override alone re-derives the masks, so the consumed masks,
    times and losses equal the uninterrupted run's (the reference's resume
    keeps the schedule's masks)."""
    out = {}
    for side, Ck, strag, SFL in (("ref", JCheckpointer, jstrag, JSFL),
                                 ("port", Checkpointer, tstrag, TSFL)):
        pop = strag.ClientPopulation(cohorts=(
            strag.Cohort(name="fast", n=2,
                         delay=strag.DelayModel(base=1.0, scale=0.0)),
            strag.Cohort(name="slow", n=2,
                         delay=strag.DelayModel(base=9.0, scale=0.0))))
        sfl_kw = dict(n_clients=4, tau=1, cut_units=1, lr_server=5e-3,
                      lr_client=1e-3, lr_global=1.0, population=pop)
        eng, cfg, sfl, params, loader, sched, key = _side(
            olmo, side, sfl_kw=sfl_kw, rounds=6, t_server=0.5)

        class DropSlow:
            def update(self, round_idx, window, metrics):
                return {"deadline": 2.0}

        infos = []
        d = str(tmp_path / side)
        res = eng.run_rounds(
            "mu_splitfed", cfg, sfl, params, loader.round_batch, sched, key,
            rounds=6, chunk_size=2, mode="python", controller=DropSlow(),
            checkpointer=Ck(d), ckpt_every=4,
            chunk_callback=lambda info, p, s: infos.append(info))
        out[side] = (np.concatenate([i.masks for i in infos]), res,
                     _meta(d, 5))
    # the port's resume from step 3
    ck = Checkpointer(str(tmp_path / "port"))
    p, s, meta = tengine.restore_run(ck, "mu_splitfed", cfg, sfl, params,
                                     loader.round_batch, step=3)
    sfl2 = tengine.apply_resume_overrides(sfl, meta, DropSlow())
    assert (sfl.deadline, sfl2.deadline) == (0.0, 2.0)
    infos2 = []
    res2 = tengine.run_rounds(
        "mu_splitfed", cfg, sfl2, p, loader.round_batch, sched, key,
        rounds=6, start_round=4, state=s, chunk_size=2, mode="python",
        controller=DropSlow(),
        chunk_callback=lambda info, p, s: infos2.append(info))
    (jm, jres, jmeta), (tm, tres, tmeta) = out["ref"], out["port"]
    np.testing.assert_array_equal(
        np.concatenate([i.masks for i in infos2]), tm[4:])
    np.testing.assert_array_equal(res2.round_times, tres.round_times[4:])
    np.testing.assert_array_equal(res2.round_loss, tres.round_loss[4:])
    assert np.array_equal(tm, np.tile([1, 1, 0, 0], (6, 1)))
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_equal(tres.round_times, jres.round_times)
    np.testing.assert_allclose(tres.round_loss, jres.round_loss, atol=TOL)
    assert tmeta["metadata"]["controller_overrides"] == \
        jmeta["metadata"]["controller_overrides"] == {"deadline": 2.0}
    assert sorted(os.listdir(tmp_path / "port")) == ["step_0000000003",
                                                    "step_0000000005"]


def test_telemetry_stitches_across_resume(olmo, tmp_path):
    """A resumed run's 'sim' records start at the resume round, and the two
    sinks tile rounds 0-3 with the uninterrupted run's durations."""
    full_sink, s1, s2 = (obs.TelemetrySink() for _ in range(3))
    _port_run(olmo, "mu_splitfed", 4, telemetry=full_sink)
    ck = Checkpointer(str(tmp_path))
    _port_run(olmo, "mu_splitfed", 2, telemetry=s1, checkpointer=ck,
              ckpt_every=2)
    _, cfg, sfl, tp, tl, _, _ = _side(olmo, "port")
    p, _, meta = tengine.restore_run(ck, "mu_splitfed", cfg, sfl, tp,
                                     tl.round_batch)
    _port_run(olmo, "mu_splitfed", 4, params=p, telemetry=s2,
              start_round=meta["step"] + 1)
    recs = s1.records("sim") + s2.records("sim")
    assert [(r.start, r.stop) for r in recs] == [(0, 2), (2, 4)]
    np.testing.assert_array_equal(
        np.concatenate([r.durations for r in recs]),
        np.concatenate([r.durations for r in full_sink.records("sim")]))


@pytest.mark.parametrize("algorithm", ["mu_splitfed", "gas"])
def test_driver_resumes_in_process(tmp_path, capsys, algorithm):
    """Two ``train.main`` calls on one --ckpt-dir (--rounds 2, then 4, with
    --ckpt-every 2 and --log-jsonl): the second prints the resume from
    round 2 and runs rounds 2-3; the log holds rounds 0-3 once each, with
    the losses of an uninterrupted run's log."""
    argv = ["--smoke", "--device", "cpu", "--seq", "16", "--clients", "3",
            "--batch", "1", "--participation", "0.67", "--straggler-scale",
            "2.0", "--chunk-size", "2", "--algorithm", algorithm,
            "--aggregation", "seed_replay"]
    ck, log, ref_log = (str(tmp_path / n) for n in ("ck", "a.jsonl",
                                                     "b.jsonl"))
    resumed = [*argv, "--ckpt-dir", ck, "--ckpt-every", "2", "--log-jsonl",
               log]
    t_train.main([*resumed, "--rounds", "2"])
    assert "[resume]" not in capsys.readouterr().out
    assert latest_good_step(ck) == 1
    res = t_train.main([*resumed, "--rounds", "4"])
    out = capsys.readouterr().out
    assert "[resume] from round 2 (tau=2)" in out
    assert "round    1" not in out and "round    3" in out
    assert len(res.round_loss) == 2 and latest_good_step(ck) == 3
    full = t_train.main([*argv, "--rounds", "4", "--log-jsonl", ref_log])
    rows = obs.read_jsonl(log, kind="round")
    want = obs.read_jsonl(ref_log, kind="round")
    assert [r["round"] for r in rows] == [0, 1, 2, 3]
    assert [r["loss"] for r in rows] == [r["loss"] for r in want]
    np.testing.assert_array_equal(full.round_loss[2:], res.round_loss)
    assert [(c["start"], c["stop"]) for c in
            obs.read_jsonl(log, kind="chunk")] == [(0, 2), (2, 4)]
