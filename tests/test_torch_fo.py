"""Port parity: the first-order baselines and what they stand on
(``repro_torch.optim``, ``core.baselines.fedavg_round`` and
``fedlora_round``, the engine's ``fedavg`` and ``fedlora`` adapters, the
driver's ``--algorithm fedavg|fedlora``, ``SyntheticSentiment`` and
``logits_fn``) against the JAX package, on the CPU.

Tolerances. Optimizer updates within 1e-6 (f32; the same IEEE operations
but for pow in AdamW's bias correction) and one bf16 ulp (bf16 leaves);
schedules within 1e-6 relative; LoRA's A within 1e-8 (the port's
threefry normal is within 4.8e-7 of jax.random.normal, times 0.01);
apply_lora within one bf16 ulp; rounds, the 3-round engine runs and
logits_fn within 1e-5 on the f32 SMOKE models (gradients summed in other
orders); masks, simulated round times and SyntheticSentiment's batches
exact. AdamW runs at the repo's first-order default lr 1e-3
(``TrainConfig.lr``): its first step sends a gradient near f32 rounding
level to a step of up to lr (tests/test_torch_gpu.py:FO_LR).
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.configs import SFLConfig as JSFL
from repro.configs import get_config as j_get_config
from repro.core import baselines as jbaselines
from repro.core import engine as jengine
from repro.core import straggler as jstrag
from repro.data import FederatedLoader as JLoader
from repro.data import SyntheticLM as JSynthetic
from repro.data import SyntheticSentiment as JSentiment
from repro.data import dirichlet_partition as j_partition
from repro.models import init_params as j_init
from repro.models import logits_fn as j_logits_fn
from repro.models import untie_params as j_untie
from repro_torch import optim as toptim
from repro_torch.configs import SFLConfig as TSFL
from repro_torch.configs import get_config as t_get_config
from repro_torch.core import baselines as tbaselines
from repro_torch.core import engine as tengine
from repro_torch.core import prng
from repro_torch.core import straggler as tstrag
from repro_torch.data import FederatedLoader as TLoader
from repro_torch.data import SyntheticLM as TSynthetic
from repro_torch.data import SyntheticSentiment as TSentiment
from repro_torch.data import dirichlet_partition as t_partition
from repro_torch.launch import train as t_train
from repro_torch.models import logits_fn as t_logits_fn
from repro_torch.models.convert import from_jax_params, to_jax_params
from repro_torch.utils import tree

TOL = 1e-5
M, SEED = 3, 0
LR = {"sgd": 1e-2, "momentum": 1e-2, "adamw": 1e-3}


def _maxdiff(t_tree, j_tree) -> float:
    got = tree.leaves(to_jax_params(t_tree))
    want = jax.tree.leaves(j_tree)
    assert len(got) == len(want)
    return max(float(np.abs(np.asarray(a, np.float32)
                            - np.asarray(b, np.float32)).max())
               for a, b in zip(got, want))


def _models(arch):
    jcfg = j_get_config(arch, smoke=True).replace(dtype="float32")
    tcfg = t_get_config(arch, smoke=True).replace(dtype="float32")
    params = j_untie(jcfg, j_init(jcfg, jax.random.PRNGKey(0)))
    return jcfg, tcfg, params, from_jax_params(params)


@pytest.fixture(scope="module")
def olmo():
    return _models("olmo-1b")


@pytest.fixture(scope="module")
def qwen3():
    return _models("qwen3-14b")


def _batches(vocab, shape, seed=1):
    toks = np.random.default_rng(seed).integers(0, vocab, shape)
    labels = np.roll(toks, -1, -1)
    return ({"tokens": jnp.asarray(toks, jnp.int32),
             "labels": jnp.asarray(labels, jnp.int32)},
            {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)})


# ---------------------------------------------------------------------------
# optim/
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["sgd", "momentum", "adamw"])
def test_optimizers_match_reference(name):
    """Three updates of a tree with f32 and bf16 leaves from the same
    gradients: parameters and moments."""
    rng = np.random.default_rng(2)
    shapes = {"a": (5, 7), "b": {"c": (3,), "d": (4, 4)}}
    params = tree.tree_map(lambda s: rng.normal(size=s).astype(np.float32),
                           shapes, )
    params["b"]["d"] = params["b"]["d"].astype(ml_dtypes.bfloat16)
    grads = [tree.tree_map(lambda s: (rng.normal(size=s) * 0.1).astype(
        np.float32), shapes) for _ in range(3)]
    j_init_fn, j_update = joptim.make_optimizer(name)
    t_init_fn, t_update = toptim.make_optimizer(name)
    jp = jax.tree.map(jnp.asarray, params)
    tp = from_jax_params(params)
    js, ts = j_init_fn(jp), t_init_fn(tp)
    for g in grads:
        jp, js = j_update(jp, jax.tree.map(jnp.asarray, g), js, LR[name])
        tp, ts = t_update(tp, from_jax_params(g), ts, LR[name])
        assert int(ts.step) == int(js.step)
        got, want = to_jax_params(tp), jp
        for a, b in zip(tree.leaves(got), jax.tree.leaves(want)):
            assert a.dtype == b.dtype
            tol = 2.0 ** -8 * np.abs(np.asarray(b, np.float32)) \
                if a.dtype == ml_dtypes.bfloat16 else 1e-6
            assert (np.abs(np.asarray(a, np.float32)
                           - np.asarray(b, np.float32)) <= tol).all()
        for tm, jm in ((ts.mu, js.mu), (ts.nu, js.nu)):
            assert (tm is None) == (jm is None)
            if tm is not None:
                assert _maxdiff(tm, jm) <= 1e-6


def test_schedules_match_reference():
    pairs = [(toptim.constant(3e-4), joptim.constant(3e-4)),
             (toptim.linear_warmup(1e-3, 5), joptim.linear_warmup(1e-3, 5)),
             (toptim.cosine(1e-3, 5, 20), joptim.cosine(1e-3, 5, 20)),
             (toptim.cosine(2e-3, 0, 10, floor=0.0),
              joptim.cosine(2e-3, 0, 10, floor=0.0))]
    for t_fn, j_fn in pairs:
        got = np.array([float(t_fn(s)) for s in range(26)], np.float32)
        want = np.array([float(j_fn(s)) for s in range(26)], np.float32)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_init_lora_matches_reference(olmo):
    """The same key gives the same adapters: A drawn in the reference's
    key order (units in dict order, wq then wv), B zeros; the tree, its
    leaf order and the parameter count equal."""
    jcfg, tcfg, jp, tp = olmo
    want = joptim.init_lora(jcfg, jp, 4, jax.random.PRNGKey(7))
    got = toptim.init_lora(tcfg, tp, 4, prng.PRNGKey(7))
    assert jax.tree.structure(to_jax_params(got)) == \
        jax.tree.structure(want)
    assert set(got["units"]["b0"]["core"]) == {"wq", "wv"}
    assert _maxdiff(got, want) <= 1e-8
    assert toptim.lora_param_count(got) == joptim.lora_param_count(want)
    for t in ("wq", "wv"):
        assert not got["units"]["b0"]["core"][t]["B"].any()


def test_apply_lora_and_the_lora_tree_cross_both_ways():
    """apply_lora on a bf16 model with random adapters within one bf16 ulp
    of the reference's (the rank sum in another order); the adapter tree
    crosses from_jax_params / to_jax_params both ways bit for bit."""
    jcfg = j_get_config("olmo-1b", smoke=True)
    tcfg = t_get_config("olmo-1b", smoke=True)
    jp = j_untie(jcfg, j_init(jcfg, jax.random.PRNGKey(0)))
    lora = joptim.init_lora(jcfg, jp, 4, jax.random.PRNGKey(1))
    rng = np.random.default_rng(4)
    lora = jax.tree.map(lambda a: jnp.asarray(
        rng.normal(size=a.shape) * 0.05, a.dtype), lora)
    want = joptim.apply_lora(jp, lora, 16.0)
    tlora = from_jax_params(lora)
    got = toptim.apply_lora(from_jax_params(jp), tlora, 16.0)
    for a, b in zip(tree.leaves(to_jax_params(got)), jax.tree.leaves(want)):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        assert (np.abs(a - b) <= 2.0 ** -8 * np.abs(b) + 1e-30).all()
    back = to_jax_params(tlora)
    for a, b in zip(tree.leaves(back), jax.tree.leaves(lora)):
        assert a.dtype == b.dtype == ml_dtypes.bfloat16
        assert np.array_equal(a.view(np.uint16),
                              np.asarray(b).view(np.uint16))
    again = from_jax_params(back)
    for a, b in zip(tree.leaves(again), tree.leaves(tlora)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the rounds
# ---------------------------------------------------------------------------

FEDAVG_CASES = [("sgd", 1), ("sgd", 2), ("adamw", 1)]


@pytest.mark.parametrize("optimizer,local_steps", FEDAVG_CASES,
                         ids=[f"{o}-E{e}" for o, e in FEDAVG_CASES])
def test_fedavg_round_matches_reference(olmo, optimizer, local_steps):
    """One FedAvg round of M=3 clients (the masked one trains too and
    weighs 0), η_g 0.3, against the reference's jitted round."""
    jcfg, tcfg, jp, tp = olmo
    shape = (M, 2, 16) if local_steps == 1 else (M, local_steps, 2, 16)
    jb, tb = _batches(jcfg.vocab_size, shape)
    mask = np.array([1.0, 0.0, 1.0], np.float32)
    lr = LR[optimizer]
    want = jax.jit(lambda p, b, m: jbaselines.fedavg_round(
        jcfg, p, b, m, lr, local_steps, optimizer, eta_g=0.3))(
        jp, jb, jnp.asarray(mask))
    got = tbaselines.fedavg_round(tcfg, tp, tb, torch.from_numpy(mask), lr,
                                  local_steps, optimizer, eta_g=0.3)
    assert _maxdiff(got, want) <= TOL
    assert _maxdiff(got, jp) > 0


def test_fedlora_round_matches_reference(qwen3):
    """One FedLoRA round on qwen3-14b SMOKE (qk-norm, GQA) from adapters
    with a nonzero B, so both A and B move; the base never does."""
    jcfg, tcfg, jp, tp = qwen3
    lora = joptim.init_lora(jcfg, jp, 4, jax.random.PRNGKey(2))
    rng = np.random.default_rng(5)
    lora = jax.tree.map(lambda a: jnp.asarray(rng.normal(size=a.shape)
                                              * 0.05, a.dtype), lora)
    jb, tb = _batches(jcfg.vocab_size, (M, 2, 16), seed=6)
    mask = np.array([1.0, 1.0, 0.0], np.float32)
    want = jax.jit(lambda lo, b, m: jbaselines.fedlora_round(
        jcfg, jp, lo, b, m, 1e-2, 16.0, eta_g=0.3))(lora, jb,
                                                    jnp.asarray(mask))
    before = [a.clone() for a in tree.leaves(tp)]
    got = tbaselines.fedlora_round(tcfg, tp, from_jax_params(lora), tb,
                                   torch.from_numpy(mask), 1e-2, 16.0,
                                   eta_g=0.3)
    assert _maxdiff(got, want) <= TOL
    for t in ("wq", "wv"):
        for ab in ("A", "B"):
            assert _maxdiff(got["units"]["b0"]["core"][t][ab],
                            lora["units"]["b0"]["core"][t][ab]) > 0
    for a, b in zip(tree.leaves(tp), before):
        assert torch.equal(a, b)


def _engine_run(eng, strag, SFL, cfg, params, loader, key, algorithm):
    sfl = SFL(n_clients=M, participation=0.67, straggler_rate=2.0)
    sched = strag.make_schedule(
        SEED, 3, population=strag.ClientPopulation.resolve(sfl),
        t_comm=0.2)
    masks = []
    res = eng.run_rounds(
        algorithm, cfg, sfl, params, loader.round_batch, sched, key,
        rounds=3, chunk_size=2, mode="python",
        chunk_callback=lambda info, p, s: masks.append(info.masks))
    return res, np.concatenate(masks), sched


@pytest.mark.parametrize("algorithm", ["fedavg", "fedlora"])
def test_run_rounds_matches_reference_engine(olmo, algorithm):
    """Three rounds of the engine's adapter on a straggler schedule (3
    clients at participation 2/3) against the reference engine's python
    mode: masks and simulated round times (the local-only model) exact;
    losses, parameters and FedLoRA's adapters within 1e-5; FedLoRA's base
    unchanged."""
    jcfg, tcfg, jp, tp = olmo
    parts = dict(labels=np.arange(256) % 10, n_clients=M, alpha=0.5,
                 seed=SEED)
    jl = JLoader(JSynthetic(jcfg.vocab_size, 16, SEED),
                 j_partition(**parts), 2, seed=SEED)
    tl = TLoader(TSynthetic(tcfg.vocab_size, 16, SEED),
                 t_partition(**parts), 2, seed=SEED)
    jr, jm, jsched = _engine_run(jengine, jstrag, JSFL, jcfg, jp, jl,
                                 jax.random.PRNGKey(SEED), algorithm)
    tr, tm, _ = _engine_run(tengine, tstrag, TSFL, tcfg, tp, tl,
                            prng.PRNGKey(SEED), algorithm)
    np.testing.assert_array_equal(tm, jm)
    assert (tm == 0).any()
    np.testing.assert_array_equal(tr.round_times, jr.round_times)
    assert tr.sim_time == jr.sim_time
    np.testing.assert_array_equal(tr.round_times, [
        jstrag.round_time_local_only(jsched.delays[r], jsched.masks[r],
                                     jsched.comm_for(jsched.masks[r]))
        for r in range(3)])
    np.testing.assert_allclose(tr.round_loss, jr.round_loss, atol=TOL)
    np.testing.assert_allclose(tr.metrics["loss"], jr.metrics["loss"],
                               atol=TOL)
    assert _maxdiff(tr.params, jr.params) <= TOL
    if algorithm == "fedlora":
        assert _maxdiff(tr.state, jr.state) <= TOL
        for a, b in zip(tree.leaves(tr.params), tree.leaves(tp)):
            assert torch.equal(a, b)
    else:
        assert _maxdiff(tr.params, jp) > 0


# ---------------------------------------------------------------------------
# data, logits and the driver
# ---------------------------------------------------------------------------

def test_synthetic_sentiment_matches_reference():
    """Bit-equal batches (with drawn and with given labels) and the same
    accuracy of the same last-position logits."""
    jds, tds = JSentiment(512, 24, seed=3), TSentiment(512, 24, seed=3)
    idx = np.arange(40) * 7
    for labels in (None, np.arange(40) % 2):
        want, got = jds.batch(idx, labels), tds.batch(idx, labels)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    logits = np.random.default_rng(0).normal(size=(40, 512)).astype(
        np.float32)
    ys = want["class"]
    assert tds.accuracy(logits, ys) == jds.accuracy(logits, ys)
    assert tds.accuracy(torch.from_numpy(logits), ys) == \
        jds.accuracy(logits, ys)


@pytest.mark.parametrize("model", ["olmo", "qwen3"])
def test_logits_fn_matches_reference(model, request):
    jcfg, tcfg, jp, tp = request.getfixturevalue(model)
    jb, tb = _batches(jcfg.vocab_size, (2, 20), seed=8)
    want = j_logits_fn(jcfg, jp, jb)
    got = t_logits_fn(tcfg, tp, tb)
    assert got.shape == want.shape
    assert float(np.abs(got.numpy() - np.asarray(want)).max()) <= TOL


@pytest.mark.parametrize("algorithm", ["fedavg", "fedlora"])
def test_driver_runs_fo_baselines_on_cpu(algorithm):
    """The driver's --algorithm fedavg|fedlora on the CPU at SMOKE size, on
    a straggler schedule: the engine's adapter with the reference driver's
    defaults (lr_client, η_g = lr_global, rank 4, alpha 16), finite losses,
    the local-only simulated clock of the reference schedule; FedAvg moves
    the parameters, FedLoRA only its adapters."""
    argv = ["--smoke", "--device", "cpu", "--rounds", "3", "--seq", "16",
            "--clients", "3", "--batch", "1", "--participation", "0.67",
            "--straggler-scale", "2.0", "--t-comm", "0.2", "--chunk-size",
            "2", "--algorithm", algorithm]
    run = t_train.setup(argv)
    before = [a.clone() for a in tree.leaves(run.params)]
    lines = []
    res, ctl = t_train.run_engine(run, log=lines.append)
    assert ctl is None and len(lines) == 3
    assert np.isfinite(res.round_loss).all()
    algo = tengine.get_algorithm(algorithm)
    assert algo.lr is None and algo.local_steps == 1
    assert algo.optimizer == "sgd"
    if algorithm == "fedlora":
        assert (algo.rank, algo.alpha) == (4, 16.0)
        for a, b in zip(tree.leaves(res.params), before):
            assert torch.equal(a, b)
        assert any(bool(leaf.any()) for leaf in tree.leaves(res.state))
    else:
        assert any(not torch.equal(a, b)
                   for a, b in zip(tree.leaves(res.params), before))
    jsfl = JSFL(n_clients=3, participation=0.67, straggler_rate=2.0)
    jsched = jstrag.make_schedule(
        0, 3, population=jstrag.ClientPopulation.resolve(jsfl), t_comm=0.2)
    np.testing.assert_array_equal(res.round_times, [
        jstrag.round_time_local_only(jsched.delays[r], jsched.masks[r],
                                     jsched.comm_for(jsched.masks[r]))
        for r in range(3)])


@pytest.mark.parametrize("name", ["sgd", "momentum", "adamw"])
def test_optimizers_leave_their_inputs(name):
    """An update returns new tensors: the parameters, the gradients (f32
    ones included, which SGD's in-place f32 arithmetic must not write)
    and the state it was given are unchanged."""
    gen = torch.Generator().manual_seed(4)
    params = {"a": torch.randn(5, 7, generator=gen),
              "b": torch.randn(4, 4, generator=gen).to(torch.bfloat16)}
    grads = {k: torch.randn(v.shape, generator=gen).to(v.dtype)
             for k, v in params.items()}
    init_fn, update = toptim.make_optimizer(name)
    state = init_fn(params)

    def inputs():
        return [*tree.leaves(params), *tree.leaves(grads), state.step,
                *(x for m in (state.mu, state.nu) if m is not None
                  for x in tree.leaves(m))]

    before = [x.clone() for x in inputs()]
    new, _ = update(params, grads, state, LR[name])
    for x, y in zip(inputs(), before, strict=True):
        assert torch.equal(x, y)
    assert all(not torch.equal(x, y) for x, y in
               zip(tree.leaves(new), tree.leaves(params)))
