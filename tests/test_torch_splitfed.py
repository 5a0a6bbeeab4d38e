"""Port parity: one MU-SplitFed round and a 3-round driver run of
``repro_torch`` against the JAX package, with counter noise, in f32 on the
olmo-1b SMOKE model; one round of the qwen3-14b SMOKE model (RMSNorm and
qk-norm through the rmsnorm op); and the port's import closure.

Tolerances: merged parameters and the round-start losses within 1e-5;
server deltas and client coefficients within 1e-5 absolute (they are
differences of nearby losses, ~1e-3; measured 1.2e-6 and 4.8e-7); the
3-round loss trajectory within 1e-4.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SFLConfig as JSFL
from repro.configs import get_config as j_get_config
from repro.core import engine
from repro.core import straggler as strag
from repro.core.splitfed import mu_splitfed_round as j_round
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
from repro_torch.core.splitfed import mu_splitfed_round as t_round
from repro_torch.data import FederatedLoader as TLoader
from repro_torch.data import SyntheticLM as TSynthetic
from repro_torch.data import dirichlet_partition as t_partition
from repro_torch.launch import train as t_train
from repro_torch.models.convert import from_jax_params, to_jax_params
from repro_torch.utils import tree

M = 3
SFL = dict(n_clients=M, tau=2, n_perturbations=2, cut_units=2,
           perturbation_dist="counter")
TOL = 1e-5
ROOT = Path(__file__).resolve().parents[1]


def _f32_models(arch):
    jcfg = j_get_config(arch, smoke=True).replace(dtype="float32")
    tcfg = t_get_config(arch, smoke=True).replace(dtype="float32")
    params = j_untie(jcfg, j_init(jcfg, jax.random.PRNGKey(0)))
    return jcfg, tcfg, params, from_jax_params(params)


@pytest.fixture(scope="module")
def setup():
    return _f32_models("olmo-1b")


@pytest.fixture(scope="module")
def qwen3_setup():
    return _f32_models("qwen3-14b")


def _maxdiff(t_tree, j_tree):
    got = tree.leaves(to_jax_params(t_tree))
    want = jax.tree.leaves(j_tree)
    assert len(got) == len(want)
    return max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
               for a, b in zip(got, want))


def _round_matches_reference(models, aggregation, cut_units,
                             eval_loss=True):
    jcfg, tcfg, jp, tp = models
    sfl_kw = dict(SFL, cut_units=cut_units)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jcfg.vocab_size, size=(M, 2, 16)).astype(np.int32)
    host = {"tokens": toks, "labels": np.roll(toks, -1, axis=-1)}
    mask = np.array([1.0, 0.0, 1.0], np.float32)       # client 1 dropped
    rk = jax.random.PRNGKey(7)
    sfl = JSFL(**sfl_kw)
    j_fn = jax.jit(lambda p, b, m, k: j_round(jcfg, sfl, p, b, m, k,
                                              aggregation=aggregation,
                                              eval_loss=eval_loss))
    jp_new, jm = j_fn(jp, {k: jnp.asarray(v) for k, v in host.items()},
                      jnp.asarray(mask), rk)
    tp_new, tm = t_round(tcfg, TSFL(**sfl_kw), tp,
                         tengine.to_device_batch(host, "cpu"),
                         torch.from_numpy(mask), np.asarray(rk),
                         aggregation=aggregation, eval_loss=eval_loss)
    assert _maxdiff(tp_new, jp_new) <= TOL
    assert _maxdiff(tp_new, jp) > 1e-4                   # it trained
    for field in jm._fields:
        got, want = getattr(tm, field).numpy(), np.asarray(getattr(jm, field))
        assert got.shape == want.shape, field
        assert np.abs(got - want).max() <= TOL, field
    loss = tm.loss.numpy()
    assert (loss != 0).all() if eval_loss else (loss == 0).all()


def test_round_without_eval_loss_matches_reference(setup):
    """eval_loss=False, which the engine's adapter passes through: the
    round-start losses are zeros on both sides and the round is unchanged."""
    _round_matches_reference(setup, "dense", SFL["cut_units"],
                             eval_loss=False)


@pytest.mark.parametrize("aggregation", ["dense", "seed_replay"])
def test_round_matches_reference(setup, aggregation):
    _round_matches_reference(setup, aggregation, SFL["cut_units"])


@pytest.mark.parametrize("aggregation", ["dense", "seed_replay"])
def test_qwen3_round_matches_reference(qwen3_setup, aggregation):
    """qwen3-14b SMOKE at its own cut (4 of 4 units on the client, as
    ``default_cut_units`` says; the server keeps the final norm and head),
    and at cut 2, which puts RMSNorm blocks on both sides."""
    for cut in (qwen3_setup[0].default_cut_units, 2):
        _round_matches_reference(qwen3_setup, aggregation, cut)


def test_driver_loss_trajectory_matches_engine(setup):
    """Three rounds of the port's driver loop (its engine, at full
    participation with counter noise) against the reference engine's
    python mode: same params, round keys, masks and batches."""
    jcfg, tcfg, jp, tp = setup
    seed, rounds, seq, batch = 0, 3, 16, 2
    parts = dict(labels=np.arange(256) % 10, n_clients=M, alpha=0.5,
                 seed=seed)
    jloader = JLoader(JSynthetic(jcfg.vocab_size, seq, seed),
                      j_partition(**parts), batch, seed=seed)
    tloader = TLoader(TSynthetic(tcfg.vocab_size, seq, seed),
                      t_partition(**parts), batch, seed=seed)
    for r in range(rounds):                  # bit-identical host batches
        want = jloader.round_batch(r)
        for k, v in tloader.round_batch(r).items():
            np.testing.assert_array_equal(v, np.asarray(want[k]))
    sfl = JSFL(**SFL)
    sched = strag.make_schedule(seed, rounds,
                                population=strag.ClientPopulation.resolve(
                                    sfl))
    want = engine.run_rounds(
        engine.get_algorithm("mu_splitfed", aggregation="seed_replay"),
        jcfg, sfl, jp, jloader.round_batch, sched, jax.random.PRNGKey(seed),
        rounds=rounds, mode="python")
    tsfl = TSFL(**SFL)
    got = tengine.run_rounds(
        "mu_splitfed", tcfg, tsfl, tp, tloader.round_batch,
        tstrag.make_schedule(seed, rounds,
                             population=tstrag.ClientPopulation.resolve(tsfl)),
        prng.PRNGKey(seed), rounds=rounds, mode="python",
        aggregation="seed_replay")
    np.testing.assert_allclose(got.round_loss, want.round_loss, atol=1e-4)
    assert _maxdiff(got.params, want.params) <= 1e-4


def test_cpu_driver_runs_and_gpu_default_needs_a_card():
    res = t_train.main(["--smoke", "--device", "cpu", "--rounds", "2",
                        "--seq", "8", "--clients", "2", "--batch", "1"])
    assert len(res.round_loss) == 2 and np.isfinite(res.round_loss).all()
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="--device cpu"):
        t_train.main(["--smoke", "--rounds", "1"])


def test_port_imports_neither_jax_nor_repro():
    """In a fresh interpreter, importing every module of repro_torch leaves
    no jax* and no repro / repro.* entry in sys.modules."""
    pkg = ROOT / "src" / "repro_torch"
    mods = sorted(
        "repro_torch." + ".".join(p.relative_to(pkg).with_suffix("").parts)
        for p in pkg.rglob("*.py") if p.name != "__init__.py")
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro') or m.startswith('jax')]\n"
        "print(len(sys.modules)); assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert {"repro_torch.kernels.threefry", "repro_torch.core.engine",
            "repro_torch.core.straggler", "repro_torch.core.population",
            "repro_torch.core.baselines", "repro_torch.core.theory",
            "repro_torch.obs.measure", "repro_torch.obs.metrics",
            "repro_torch.obs.runlog", "repro_torch.obs.telemetry",
            "repro_torch.obs.trace", "repro_torch.optim.optimizers",
            "repro_torch.optim.schedules", "repro_torch.optim.lora"
            } <= set(mods)
    assert len(mods) >= 32


@pytest.mark.parametrize("script", ["chip_smoke.py", "tools/flash_sweep.py",
                                    "tools/flash_bwd_sweep.py",
                                    "tools/zo_sweep.py",
                                    "tools/threefry_sweep.py"])
def test_chip_scripts_import_neither_jax_nor_repro(script):
    """The card's machine has no jax: the scripts run there import the
    port and torch only (checked in a fresh interpreter); each sweep's
    edits still apply to the committed kernel source it names."""
    code = (
        "import importlib.util, sys\n"
        f"spec = importlib.util.spec_from_file_location('s', {str(ROOT / script)!r})\n"
        "m = importlib.util.module_from_spec(spec); spec.loader.exec_module(m)\n"
        "if hasattr(m, 'VARIANTS'):\n"
        "    src = (m.build.CSRC / m.SOURCE).read_text()\n"
        "    for edits in m.VARIANTS.values(): m.variant_source(src, edits)\n"
        "bad = [n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'repro') or n.startswith('jax')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_zo_sweep_alu_u32_to_float_is_exact():
    """tools/zo_sweep.py's "ALU u32->float" variant takes float(h) as two
    exact 16-bit magic numbers and one rounded add; emulated in numpy f32
    (the variant's fused multiply-add has an exact product and an exact
    sum) it equals np.float32(h), round to nearest even, at 2^24 seeded hash
    values and the edges: 0, 1, 2^24 ± 1, round-to-even ties, and the top
    of the range, where float(h) rounds up to 2^32 (h >= 2^32 - 128)."""
    f32 = np.float32
    edges = np.array(
        [0, 1, 2, 2 ** 24 - 1, 2 ** 24, 2 ** 24 + 1, 2 ** 24 + 3, 2 ** 25 + 2,
         2 ** 25 + 6, 0x7FFFFFC0, 0x80000080, 0x80000180, 2 ** 32 - 257,
         2 ** 32 - 256, 2 ** 32 - 129, 2 ** 32 - 128, 2 ** 32 - 2,
         2 ** 32 - 1], np.uint32)
    h = np.concatenate([edges, np.random.default_rng(20260).integers(
        0, 2 ** 32, size=2 ** 24, dtype=np.uint64).astype(np.uint32)])
    hi = ((h >> 16) | 0x4B000000).view(f32) * f32(65536.0) - f32(2.0 ** 39)
    lo = ((h & 0xFFFF) | 0x4B000000).view(f32) - f32(2.0 ** 23)
    got, want = hi + lo, h.astype(f32)
    bad = np.flatnonzero(got.view(np.uint32) != want.view(np.uint32))
    assert bad.size == 0, (f"{bad.size} values differ, first at h = "
                           f"{h[bad[0]]}: {got[bad[0]]!r} vs {want[bad[0]]!r}")
