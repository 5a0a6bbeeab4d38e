"""Port parity: xLSTM (``repro_torch.models.ssm``'s mLSTM and sLSTM
blocks, the sLSTM recurrence's plain version ``kernels/ref.py:slstm_ref``,
the xLSTM block patterns of ``models/transformer.py``) against the JAX
package on xlstm-350m SMOKE (8 layers in 2 units of the pattern mlstm ×3,
slstm; d_model 64, no FFN; mLSTM d_up 128 in 4 heads of 32, chunk 16;
sLSTM 4 heads of 16, GeGLU width 85), with the port's parameters carried
to the reference by the converter. Sequences of 40 tokens: two 16-token
chunks of the mLSTM and its 8-token tail (``ssm.py:224-229``).

Tolerances (f32 unless named). The sLSTM recurrence: h, c and n within
1e-5 of their largest magnitude after 40 tokens (the recurrent product
sums in another order; the gates' transcendentals are the CPU's, not
XLA's), m within 1e-5 of max(|m|, 1). ``mlstm_forward``'s y and state in
f32 within 1e-5 of each largest magnitude (the chunk's einsums contract in
another order); in bf16 y within 2^-5 of max|y| and the state within
2^-5 of its largest magnitude (the bf16 projections round their sums in
another order, a bf16 ulp of q, k and v, carried through the chunks).
Each block's decode steps within 1e-5. The model's forward halves, loss,
logits, one MU-SplitFed round (counter noise, seed replay on the port,
the reference's ``replay="scan"``), prefill, decode steps and their caches
within 1e-4 of max(the quantity's largest magnitude, 1). The port's own
prefill and decode against its own logits_fn within 1e-4 of that scale.
The converter keeps every bit.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from one_torch_thread import one_torch_thread  # noqa: F401
from repro.configs import SFLConfig as JSFL
from repro.configs import get_config as j_get_config
from repro.core.splitfed import mu_splitfed_round as j_round
from repro.launch import serve as j_serve
from repro.models import client_forward as j_client
from repro.models import init_cache as j_init_cache
from repro.models import init_params as j_init
from repro.models import logits_fn as j_logits
from repro.models import prefill as j_prefill
from repro.models import server_forward as j_server
from repro.models import split_dims as j_split_dims
from repro.models import split_params as j_split
from repro.models import ssm as j_ssm
from repro.models import untie_params as j_untie
from repro_torch.configs import SFLConfig as TSFL
from repro_torch.configs import card_smoke_config
from repro_torch.configs import get_config as t_get_config
from repro_torch.core import prng
from repro_torch.core.splitfed import mu_splitfed_round
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve
from repro_torch.launch import train as t_train
from repro_torch.models import (client_forward, decode_step, init_cache,
                                init_params, logits_fn, loss_fn, prefill,
                                server_forward, split_dims, split_params,
                                ssm, untie_params)
from repro_torch.models.convert import from_jax_params, to_jax_params
from repro_torch.utils import tree

ARCH = "xlstm-350m"
B, S, GEN = 2, 40, 8


@pytest.fixture(autouse=True, scope="module")
def cached_reference_traces():
    """For this module, the reference's counter noise (``counter_gauss2``)
    and its xLSTM blocks' forwards and decodes run under ``jax.jit``: the
    same functions, traced once a shape instead of once a call site. A
    round traces the noise for 7 sweeps of every leaf and the blocks in 8
    forwards; with the traces cached its lowering takes about 7 s instead
    of 21, and its results are bit-equal (measured on this round)."""
    import repro.kernels.ref as j_ref
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_ref, "counter_gauss2", jax.jit(j_ref.counter_gauss2))
        for name in ("mlstm_forward", "mlstm_decode", "slstm_forward",
                     "slstm_decode"):
            mp.setattr(j_ssm, name, jax.jit(getattr(j_ssm, name),
                                            static_argnums=0))
        yield


@functools.lru_cache(maxsize=None)
def _shapes(dtype):
    """The reference's parameter tree for ``dtype`` as shapes and dtypes."""
    jcfg = j_get_config(ARCH, smoke=True).replace(dtype=dtype)
    return jax.eval_shape(lambda: j_untie(jcfg, j_init(
        jcfg, jax.random.PRNGKey(0))))


@functools.lru_cache(maxsize=None)
def _params(dtype):
    """(the reference's copy, the port's parameters): the port's
    ``init_params`` from seed 0 (the reference's shapes, dtypes and init
    scales, held by ``test_init_params_and_split_dims_match_reference``),
    carried to the reference by the converter. The reference's own init
    would cost a compile of about 4 s a dtype."""
    tcfg = t_get_config(ARCH, smoke=True).replace(dtype=dtype)
    params = untie_params(tcfg, init_params(
        tcfg, torch.Generator().manual_seed(0)))
    return jax.tree.map(jnp.asarray, to_jax_params(params)), params


def _model(dtype="float32"):
    """(reference config, port config, reference params, port params)."""
    jcfg = j_get_config(ARCH, smoke=True).replace(dtype=dtype)
    tcfg = t_get_config(ARCH, smoke=True).replace(dtype=dtype)
    return (jcfg, tcfg) + _params(dtype)


@functools.lru_cache(maxsize=None)
def _jit(fn, cfg, **kw):
    """The reference's ``fn`` for ``cfg``, jitted once per module."""
    return jax.jit(functools.partial(fn, cfg, **kw))


@functools.lru_cache(maxsize=None)
def _tokens():
    return np.random.default_rng(1).integers(
        0, 256, (B, S + GEN)).astype(np.int32)


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _err(got, want):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max())


def _assert_rel(got, want, tol, floor=1.0):
    """max|got - want| <= tol · max(max|want|, floor)."""
    assert _err(got, want) <= tol * max(float(np.abs(_f32(want)).max()),
                                        floor)


def _assert_tree(got, want, tol):
    got = to_jax_params(got)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.dtype == b.dtype
        _assert_rel(a, b, tol)


def _core(params, j, unit=0):
    """Pattern block j's core parameters of one unit (b0-b2 mLSTM, b3
    sLSTM)."""
    return jax.tree.map(lambda a: a[unit], params["units"][f"b{j}"]["core"])


def _t_core(params, j, unit=0):
    return tree.tree_map(lambda a: a[unit], params["units"][f"b{j}"]["core"])


def _x(dtype, n, seed=7, width=64):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, n, width)).astype(np.float32)
    return (jnp.asarray(x, dtype=jnp.dtype(dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def _state(init_state, cfg, nonzero, seed=11):
    """The reference's initial state of a block as numpy, made nonzero
    (normal draws; a stabiliser m drawn near 0) where asked."""
    st = {k: np.asarray(v) for k, v in init_state(cfg, B).items()}
    if nonzero:
        rng = np.random.default_rng(seed)
        for k in sorted(st):
            st[k] = (rng.standard_normal(st[k].shape) * 0.5).astype(
                np.float32)
        if "n" in st and st["n"].ndim == 3 and "C" not in st:
            st["n"] = np.abs(st["n"]) + 1.0     # sLSTM's n >= exp(-m) > 0
    return st


def _both(st):
    return ({k: jnp.asarray(v) for k, v in st.items()},
            {k: torch.from_numpy(v.copy()) for k, v in st.items()})


# ---------------------------------------------------------------------------
# the sLSTM recurrence and the blocks
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _j_slstm_scan(cfg):
    def run(p, state, x_pre):
        def body(st, xp):
            return j_ssm._slstm_step(cfg, p, st, xp)
        return jax.lax.scan(body, state, x_pre.swapaxes(0, 1))
    return jax.jit(run)


@pytest.mark.parametrize("n,nonzero", [(S, False), (S, True), (1, True)],
                         ids=["zero_state", "state", "one_token"])
def test_slstm_ref_matches_the_reference_step_scan(n, nonzero):
    """slstm_ref on the sLSTM block's pre-activations (the w_x product of a
    normal input, scaled by 4 so that the gates leave their linear range)
    against the reference's ``_slstm_step`` under ``lax.scan``, from the
    initial and from a nonzero state, and at one token: hs and the final
    c, n, h within 1e-5 of their largest magnitude, m within 1e-5 of
    max(|m|, 1)."""
    jcfg, tcfg, jp, tp = _model()
    jc, tc = _core(jp, 3), _t_core(tp, 3)
    rng = np.random.default_rng(5)
    x_pre = (rng.standard_normal((B, n, 64)).astype(np.float32)
             @ np.asarray(jc["w_x"]) * 4.0).astype(np.float32)
    st = _state(j_ssm.slstm_init_state, jcfg, nonzero)
    jst, tst = _both(st)
    (want_st, want_h) = _j_slstm_scan(jcfg)(jc, jst, jnp.asarray(x_pre))
    hs, (c, nn, m, h) = ref.slstm_ref(torch.from_numpy(x_pre), tc["b"],
                                      tc["r"], tst["c"], tst["n"], tst["m"],
                                      tst["h"])
    assert hs.dtype == torch.float32 and tuple(hs.shape) == (B, n, 64)
    _assert_rel(hs, np.asarray(want_h).swapaxes(0, 1), 1e-5, floor=0.0)
    for got, k in ((c, "c"), (nn, "n"), (h, "h")):
        _assert_rel(got, want_st[k], 1e-5, floor=0.0)
    _assert_rel(m, want_st["m"], 1e-5)


def test_slstm_op_writes_the_state_in_place_on_the_cpu():
    """The wrapper on CPU tensors runs the plain version; ``out`` (the
    input state itself, as decode passes it) receives the final state,
    equal to a call that returns a new one."""
    _, tcfg, _, tp = _model()
    tc = _t_core(tp, 3)
    rng = np.random.default_rng(2)
    x_pre = torch.from_numpy(rng.standard_normal((1, 3, 256)).astype(
        np.float32))
    st = [torch.from_numpy(rng.standard_normal((1, 4, 16)).astype(
        np.float32)) for _ in range(4)]
    st[1] = st[1].abs() + 1.0
    hs, final = ops.slstm_op(x_pre, tc["b"], tc["r"], *st)
    state = [s.clone() for s in st]
    hs2, got = ops.slstm_op(x_pre, tc["b"], tc["r"], *state, out=state)
    assert torch.equal(hs2, hs)
    assert all(g is s and torch.equal(s, f)
               for g, s, f in zip(got, state, final))
    assert not torch.equal(state[3], st[3])


@pytest.mark.parametrize("dtype,nonzero", [
    ("float32", False), ("float32", True), ("bfloat16", False),
    ("bfloat16", True)], ids=["f32", "f32_state", "bf16", "bf16_state"])
def test_mlstm_forward_matches_reference(dtype, nonzero):
    """The first mLSTM block's mlstm_forward at S = 40 (two 16-token
    chunks and the 8-token tail) from the initial and from a nonzero
    state: y and the final C, n, m. f32 within 1e-5 of each largest
    magnitude (m of max(|m|, 1)); bf16 within 2^-5."""
    jcfg, tcfg, jp, tp = _model(dtype)
    jx, tx = _x(dtype, S)
    jst, tst = _both(_state(j_ssm.mlstm_init_state, jcfg, nonzero))
    want, wstate = _jit(j_ssm.mlstm_forward, jcfg)(_core(jp, 0), jx, jst)
    got, gstate = ssm.mlstm_forward(tcfg, _t_core(tp, 0), tx, tst)
    assert got.dtype == tx.dtype
    assert all(gstate[k].dtype == torch.float32 for k in ("C", "n", "m"))
    tol = 1e-5 if dtype == "float32" else 2.0 ** -5
    _assert_rel(got, want, tol, floor=0.0)
    _assert_rel(gstate["C"], wstate["C"], tol, floor=0.0)
    _assert_rel(gstate["n"], wstate["n"], tol, floor=0.0)
    _assert_rel(gstate["m"], wstate["m"], tol)


@pytest.mark.parametrize("block", ["mlstm", "slstm"])
def test_decode_matches_reference_for_four_steps(block):
    """A block's decode for 4 tokens from its forward's state after a
    12-token prompt (the reference's decode step by step): each step's y
    and the carried state within 1e-5 (m of max(|m|, 1)); the port's state
    tensors are updated in place."""
    jcfg, tcfg, jp, tp = _model()
    j = 0 if block == "mlstm" else 3
    fwd, dec = ((ssm.mlstm_forward, ssm.mlstm_decode) if block == "mlstm"
                else (ssm.slstm_forward, ssm.slstm_decode))
    jfwd, jdec = ((j_ssm.mlstm_forward, j_ssm.mlstm_decode)
                  if block == "mlstm"
                  else (j_ssm.slstm_forward, j_ssm.slstm_decode))
    jx, tx = _x("float32", 16)
    jc, tc = _core(jp, j), _t_core(tp, j)
    _, jstate = _jit(jfwd, jcfg)(jc, jx[:, :12])
    _, tstate = fwd(tcfg, tc, tx[:, :12])
    held = dict(tstate)
    step = _jit(jdec, jcfg)
    for i in range(12, 16):
        want, jstate = step(jc, jx[:, i:i + 1], jstate)
        got, tstate = dec(tcfg, tc, tx[:, i:i + 1], tstate)
        assert all(tstate[k] is held[k] for k in held)
        _assert_rel(got, want, 1e-5, floor=0.0)
        for k in held:
            _assert_rel(tstate[k], jstate[k], 1e-5,
                        floor=1.0 if k == "m" else 0.0)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_init_params_and_split_dims_match_reference():
    """The port's init_params has the reference's tree: keys b0..b3, no
    norm2 or ffn in any block, leaf order (the noise salt is the leaf
    index), shapes and dtypes (w_i, w_f, b_i, b_f, r and b f32 in a bf16
    model); split_dims equal at both cuts of SMOKE and at the published
    config's default cut (499,723,408 parameters in all)."""
    jcfg = j_get_config(ARCH, smoke=True)
    tcfg = t_get_config(ARCH, smoke=True)
    shapes = _shapes(jcfg.dtype)
    mine = untie_params(tcfg, init_params(tcfg, torch.Generator()
                                          .manual_seed(0)))
    want, _ = jax.tree_util.tree_flatten_with_path(shapes)
    got = tree.path_leaves(mine)
    assert [jax.tree_util.keystr(p) for p, _ in want] == [
        "".join(f"['{k}']" for k in path.split("/")) for path, _ in got]
    for (_, a), (_, b) in zip(want, got):
        assert a.shape == tuple(b.shape) and a.dtype.name == str(
            b.dtype).split(".")[-1]
    units = mine["units"]
    assert sorted(units) == [f"b{j}" for j in range(4)]
    assert all(sorted(units[f"b{j}"]) == ["core", "norm1"] for j in range(4))
    assert sorted(units["b3"]["core"]) == ["b", "r", "w_down", "w_up", "w_x"]
    assert units["b0"]["core"]["w_i"].dtype == torch.float32
    assert units["b3"]["core"]["r"].dtype == torch.float32
    assert float(units["b3"]["core"]["b"][0, 128]) == 3.0
    for cut in (1, 2):
        assert split_dims(tcfg, cut) == j_split_dims(jcfg, cut)
    full_j, full_t = j_get_config(ARCH), t_get_config(ARCH)
    assert split_dims(full_t, 1) == j_split_dims(full_j, 1)
    assert sum(split_dims(full_t, 1)) == 499_723_408


def _batches(n=2, seed=3, seq=S):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 256, (n, 1, seq)).astype(np.int32)
    labels = np.roll(toks, -1, -1)
    j = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    t = {"tokens": torch.from_numpy(toks.astype(np.int64)),
         "labels": torch.from_numpy(labels.astype(np.int64))}
    return j, t


def test_forward_halves_loss_and_logits_match_reference():
    """client_forward's h, server_forward's loss, loss_fn and logits_fn
    against the reference at the default cut (1 of 2 units), within 1e-4
    of max(|·|, 1)."""
    jcfg, tcfg, jp, tp = _model()
    jb, tb = _batches(n=1)
    jb = {k: v[0] for k, v in jb.items()}
    tb = {k: v[0] for k, v in tb.items()}
    jc, js = j_split(jcfg, jp, 1)
    tc, ts = split_params(tcfg, tp, 1)
    jh, th = _jit(j_client, jcfg)(jc, jb), client_forward(tcfg, tc, tb)
    _assert_rel(th["h"], jh["h"], 1e-4)
    want = _jit(j_server, jcfg)(js, jh, jb)
    _assert_rel(server_forward(tcfg, ts, th, tb), want, 1e-4)
    _assert_rel(loss_fn(tcfg, tp, tb), want, 1e-4)
    _assert_rel(logits_fn(tcfg, tp, tb), _jit(j_logits, jcfg)(jp, jb), 1e-4)


# the server's learning rate of the round test. At the default 1e-2 one
# SPSA step at SMOKE width moves every server weight by about 0.17·u (the
# coefficient lr·δ/(2λ) with δ up to 0.17, λ = 5e-3); there the mLSTM's
# activations reach ~700, and both packages' f32 forwards amplify rounding:
# on the second mLSTM block at such weights the reference against itself
# with its input moved by 6e-8 relative differs by 0.053 of max|y| 687,
# the port against the reference by 0.048 (a round's client delta by
# 2.4e-3). At 1e-3 (steps of about 0.017·u) both stay within f32 rounding.
ROUND_LR_SERVER = 1e-3


def test_mu_splitfed_round_matches_reference():
    """One MU-SplitFed round (counter noise, M=2 at weights 1 and 0.5, τ=2,
    P=1, cut after the first unit, lr_server ``ROUND_LR_SERVER``; seed
    replay on the port, one kernel sweep of the records a leaf, and the
    reference's ``replay="scan"``, which applies them one at a time in
    jnp) over every mLSTM, sLSTM and norm leaf: parameters and metrics
    within 1e-4."""
    jcfg, tcfg, jp, tp = _model()
    kw = dict(n_clients=2, tau=2, n_perturbations=1, cut_units=1,
              perturbation_dist="counter", lr_server=ROUND_LR_SERVER)
    jb, tb = _batches()
    mask = np.array([1.0, 0.5], np.float32)
    got_p, got_m = mu_splitfed_round(
        tcfg, TSFL(**kw), tp, tb, torch.from_numpy(mask), prng.PRNGKey(6),
        aggregation="seed_replay")
    want_p, want_m = jax.jit(functools.partial(
        j_round, jcfg, JSFL(**kw), aggregation="seed_replay",
        replay="scan"))(jp, jb, jnp.asarray(mask), jax.random.PRNGKey(6))
    _assert_tree(got_p, want_p, 1e-4)
    for f in want_m._fields:
        _assert_rel(getattr(got_m, f), getattr(want_m, f), 1e-4)


def test_init_cache_prefill_and_decode_match_reference():
    """init_cache's layout (mLSTM {"C" (2, B, 4, 32, 32), "n", "m"}, sLSTM
    {"c", "n", "m", "h"} (2, B, 4, 16), all f32, every "m" at -1e30)
    equals the reference's; prefill's last logits and cache, then 8 decode
    steps' logits and caches (the reference's decode_step_jit), within
    1e-4; the port's decode steps reproduce its own logits_fn on the
    prompt and the tokens within 1e-4."""
    jcfg, tcfg, jp, tp = _model()
    want = j_init_cache(jcfg, B, S + GEN)
    got = init_cache(tcfg, B, S + GEN, device="cpu")
    assert tuple(got["b0"]["C"].shape) == (2, B, 4, 32, 32)
    assert sorted(got["b3"]) == ["c", "h", "m", "n"]
    assert tuple(got["b3"]["h"].shape) == (2, B, 4, 16)
    assert float(got["b0"]["m"].max()) == float(got["b3"]["m"].min()) == float(
        np.float32(-1e30))
    _assert_tree(got, want, 0.0)
    toks = _tokens()
    jl, jc = j_prefill(jcfg, jp, {"tokens": jnp.asarray(toks[:, :S])},
                       cache_len=S + GEN)
    tl, tc = prefill(tcfg, tp, {"tokens": torch.from_numpy(
        toks[:, :S].astype(np.int64))}, cache_len=S + GEN)
    _assert_rel(tl, jl, 1e-4)
    _assert_tree(tc, jc, 1e-4)
    full = logits_fn(tcfg, tp, {"tokens": torch.from_numpy(
        toks.astype(np.int64))})
    _assert_rel(tl[:, 0], full[:, S - 1], 1e-4)
    step = j_serve.decode_step_jit(jcfg)
    for i in range(GEN):
        tok = toks[:, S + i:S + i + 1]
        jl, jc = step(jp, jnp.asarray(tok), jc, jnp.int32(S + i))
        tl, tc = decode_step(tcfg, tp, torch.from_numpy(tok.astype(np.int64)),
                             tc, S + i)
        _assert_rel(tl, jl, 1e-4)
        _assert_tree(tc, jc, 1e-4)
        _assert_rel(tl[:, 0], full[:, S + i], 1e-4)


def test_driver_and_serve_main_run_xlstm_on_the_cpu(capsys):
    """``launch.train --arch xlstm-350m --smoke --device cpu --rounds 2``
    (M=2, seq 16): finite losses and moved parameters; ``launch.serve`` on
    the same arch generates (B, gen) tokens."""
    run = t_train.setup(["--arch", ARCH, "--smoke", "--device", "cpu",
                         "--clients", "2", "--batch", "1", "--seq", "16",
                         "--rounds", "2"])
    init = [a.clone() for a in tree.leaves(run.params)]
    res, _ = t_train.run_engine(run, log=None)
    assert len(res.round_loss) == 2 and np.isfinite(res.round_loss).all()
    moved = [not torch.equal(a, b) for a, b in zip(tree.leaves(res.params),
                                                   init)]
    assert all(moved)
    toks = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "20", "--gen", "3"])
    assert tuple(toks.shape) == (2, 3)
    assert "generated (2, 3)" in capsys.readouterr().out


def test_converter_round_trips_xlstm_parameters_and_cache():
    """bf16 xlstm SMOKE parameters (with their f32 gate, bias and
    recurrent leaves) and the reference's bf16 prefill cache (all f32) go
    numpy -> tensors -> numpy bit for bit, with their dtypes."""
    jcfg, _, jp, tp = _model("bfloat16")
    core = tp["units"]["b3"]["core"]
    assert {k: str(core[k].dtype) for k in ("r", "b", "w_x")} == {
        "r": "torch.float32", "b": "torch.float32",
        "w_x": "torch.bfloat16"}
    _, cache = j_prefill(jcfg, jp, {"tokens": jnp.asarray(_tokens()[:, :S])},
                         cache_len=S + GEN)
    assert cache["b0"]["C"].dtype == jnp.float32
    assert cache["b3"]["h"].dtype == jnp.float32
    for t in (jp, cache):
        back = to_jax_params(from_jax_params(t))
        assert jax.tree.structure(back) == jax.tree.structure(t)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(t)):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a.view(np.uint8),
                                          np.asarray(b).view(np.uint8))


def test_card_smoke_config_widens_xlstm():
    """configs.card_smoke_config('xlstm-350m'): d_model 128 in f32, SMOKE's
    xlstm (4 heads, chunk 16): the mLSTM d_up 256 in heads of 64, the
    sLSTM's heads of 32 (one kernel block a head), the published
    pattern."""
    cfg = card_smoke_config(ARCH)
    assert (cfg.d_model, cfg.dtype) == (128, "float32")
    assert ssm.mlstm_dims(cfg) == (256, 4, 64, 16)
    assert ssm.slstm_dims(cfg) == (4, 32)
    assert cfg.block_pattern == t_get_config(ARCH).block_pattern
