"""Port parity: the sLSTM recurrence's gradient (``kernels/ref.py:
slstm_bwd_ref``, the plain version of ``csrc/slstm_bwd.cu``, and
``kernels/slstm.py``'s autograd Function), the xLSTM blocks' gradients,
and FedAvg and FedLoRA rounds on xlstm-350m SMOKE, against the JAX package
on the CPU.

Tolerances. f32: each gradient within 1e-5 of its largest magnitude (the
reference's scan sums the recurrent product and dr over t in another
order, and its transcendentals are XLA's); bf16: dx_pre within 2^-7 of its
largest magnitude (it is rounded to bf16 on both sides, where an f32
difference can move a rounding), the rest as in f32. The blocks in f32
within 1e-5. Rounds within 1e-4 of max(|leaf|, 1) over every leaf, at
S = 40 (the mLSTM's two 16-token chunks and its 8-token tail).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from one_torch_thread import one_torch_thread  # noqa: F401
from repro import optim as joptim
from repro.configs import get_config as j_get_config
from repro.core import baselines as jbase
from repro.models import ssm as j_ssm
from repro_torch.configs import get_config as t_get_config
from repro_torch.core import baselines as tbase
from repro_torch.core import engine as tengine
from repro_torch.kernels import ref
from repro_torch.kernels.slstm import slstm
from repro_torch.launch import train as t_train
from repro_torch.models import init_params, ssm, untie_params
from repro_torch.models.convert import from_jax_params, to_jax_params
from repro_torch.utils import tree

ARCH = "xlstm-350m"
NAMES = ("x_pre", "b", "r", "c", "n", "m", "h")
# (B, S, H, dh): SMOKE's sLSTM (4 heads of 16), the card SMOKE's head dim
# 32, one head of 64, one token
SHAPES = [(2, 40, 4, 16), (1, 17, 2, 32), (3, 9, 1, 64), (2, 1, 4, 16)]


@pytest.fixture(autouse=True, scope="module")
def cached_reference_traces():
    """The reference's xLSTM blocks run under ``jax.jit`` in this module,
    traced once a shape (as tests/test_torch_xlstm.py does)."""
    with pytest.MonkeyPatch.context() as mp:
        for name in ("mlstm_forward", "slstm_forward"):
            mp.setattr(j_ssm, name, jax.jit(getattr(j_ssm, name),
                                            static_argnums=0))
        yield


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _assert_grad(got, want, tol, what=""):
    """max|got - want| <= tol · max|want|, shapes equal."""
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), (what, err)


def _inputs(B, S, H, dh, dtype, state, seed=5):
    """The recurrence's inputs and cotangents as numpy arrays: x_pre a
    normal times 2 (rounded to ``dtype``), b with its forget quarter at
    3.0, r at 1/sqrt(dh); the initial state ("init": zeros, m at -1e30), a
    nonzero one ("state": c and h normal, n >= 1, m near 0), or the exact
    tie ("tie": the initial state and pre_i = 0 at token 0, where n' =
    max(f_g·n + i_g, exp(-m')) = max(1, 1)); dhs (in ``dtype``) and the
    final state's four cotangents."""
    rng = np.random.default_rng(seed)

    def normal(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    D = H * dh
    x = normal(B, S, 4 * D, scale=2.0)
    b = np.zeros(4 * D, np.float32)
    b[2 * D:3 * D] = 3.0
    r = normal(4, H, dh, dh, scale=1.0 / np.sqrt(dh))
    if state == "state":
        st = [normal(B, H, dh), np.abs(normal(B, H, dh)) + 1.0,
              normal(B, H, dh, scale=0.5), normal(B, H, dh, scale=0.5)]
    else:
        z = np.zeros((B, H, dh), np.float32)
        st = [z, z.copy(), np.full_like(z, -1e30), z.copy()]
    if state == "tie":
        x[:, 0, D:2 * D] = 0.0
    dhs = normal(B, S, D)
    if dtype == "bfloat16":
        bf = jnp.bfloat16
        x = np.asarray(jnp.asarray(x, bf).astype(jnp.float32))
        dhs = np.asarray(jnp.asarray(dhs, bf).astype(jnp.float32))
    return [x, b, r, *st], dhs, [normal(B, H, dh) for _ in range(4)]


def _torch(arrs, dhs, dtype):
    td = getattr(torch, dtype)
    ins = [torch.from_numpy(np.array(a)) for a in arrs]
    ins[0] = ins[0].to(td)
    return ins, torch.from_numpy(np.array(dhs)).to(td)


@functools.lru_cache(maxsize=None)
def _j_vjp(H, dh, dtype):
    """jax.vjp of the reference's recurrence, ``_slstm_step`` under
    ``lax.scan`` as ``slstm_forward`` runs it, from x_pre (in ``dtype``),
    b, r and the state to (hs in ``dtype``, the final state), jitted."""
    cfg = j_get_config(ARCH, smoke=True)
    cfg = cfg.replace(d_model=H * dh, xlstm=dataclasses.replace(
        cfg.xlstm, n_heads=H))
    jd = jnp.dtype(dtype)

    def chain(x_pre, b, r, c, n, m, h):
        def body(st, xp):
            return j_ssm._slstm_step(cfg, {"b": b, "r": r}, st, xp)
        st, hs = jax.lax.scan(body, {"c": c, "n": n, "m": m, "h": h},
                              x_pre.astype(jd).swapaxes(0, 1))
        return (hs.swapaxes(0, 1).astype(jd),
                (st["c"], st["n"], st["m"], st["h"]))

    def grads(args, cts):
        _, vjp = jax.vjp(chain, *args)
        return vjp(cts)
    return jax.jit(grads)


CASES = [(s, st) for s in SHAPES for st in ("init", "state")] + [
    ((1, 3, 1, 16), "tie")]


def _ids(case):
    return "x".join(map(str, case[0])) + "_" + case[1]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_slstm_bwd_ref_matches_autograd_and_jax_vjp(case, dtype):
    """slstm_bwd_ref with nonzero dhs and final-state cotangents against
    torch.autograd of slstm_ref (the same forward differentiated op by op)
    and against jax.vjp of the reference's scan: f32 within 1e-5, bf16
    dx_pre within 2^-7 of each gradient's largest magnitude; the autograd
    Function on CPU tensors (``slstm`` under autograd) returns
    slstm_bwd_ref's gradients exactly. At the tie n' = max(1, 1) at every
    column of token 0, and both sides split its cotangent half and half."""
    shape, state = case
    arrs, dhs, dfin = _inputs(*shape, dtype, state)
    ins, tdhs = _torch(arrs, dhs, dtype)
    tfin = [torch.from_numpy(a) for a in dfin]
    got = ref.slstm_bwd_ref(*ins, tdhs, *tfin)
    tol = [2.0 ** -7 if dtype == "bfloat16" else 1e-5] + [1e-5] * 6
    for g, t in zip(got, ins):
        assert g.dtype == t.dtype and g.shape == t.shape
    if state == "tie":
        B, S, H, dh = shape
        pre = torch.from_numpy(arrs[0][:, 0]).reshape(B, 4, H, dh)
        lfm = ref.log_sigmoid(pre[:, 2]) + ins[5]
        assert bool((torch.maximum(lfm, pre[:, 1]) == 0.0).all())
    req = [t.clone().requires_grad_() for t in ins]
    hs, fin = ref.slstm_ref(*req)
    want = torch.autograd.grad((hs, *fin), req, (tdhs, *tfin))
    for name, g, w, k in zip(NAMES, got, want, tol):
        _assert_grad(g, w, k, f"autograd {name}")
    req = [t.clone().requires_grad_() for t in ins]
    hs, fin = slstm(*req)
    fn = torch.autograd.grad((hs, *fin), req, (tdhs, *tfin))
    assert all(torch.equal(a, b) for a, b in zip(fn, got))
    jd = jnp.dtype(dtype)
    jargs = [jnp.asarray(a) for a in arrs]
    jargs[0] = jargs[0].astype(jd)
    jw = _j_vjp(shape[2], shape[3], dtype)(
        tuple(jargs), (jnp.asarray(dhs, jd), tuple(map(jnp.asarray, dfin))))
    for name, g, w, k in zip(NAMES, got, jw, tol):
        _assert_grad(g, w, k, f"jax {name}")


def test_slstm_record_ref_holds_each_tokens_inputs():
    """slstm_record_ref, the saving forward's record: token 0 holds the
    initial state, token t the pre-activations (x_pre + b plus the
    recurrent product of h_{t-1}) and h_{t-1} = hs[t-1] (f32); the
    backward from the record equals the one that makes it."""
    arrs, dhs, dfin = _inputs(2, 6, 2, 16, "float32", "state")
    ins, tdhs = _torch(arrs, dhs, "float32")
    rec = ref.slstm_record_ref(*ins)
    hs, _ = ref.slstm_ref(*ins)
    assert tuple(rec.shape) == (2, 6, 8, 32) and rec.dtype == torch.float32
    for k in range(4):
        assert torch.equal(rec[:, 0, 4 + k], ins[3 + k].reshape(2, 32))
    assert torch.equal(rec[:, 1:, 7], hs[:, :-1])
    pre0 = (ins[0][:, 0] + ins[1]).reshape(2, 4, 2, 16) + torch.einsum(
        "bhd,ghde->bghe", ins[6], ins[2])
    assert torch.equal(rec[:, 0, :4], pre0.reshape(2, 4, 32))
    tfin = [torch.from_numpy(a) for a in dfin]
    got = ref.slstm_bwd_ref(*ins, tdhs, *tfin, saved=rec)
    want = ref.slstm_bwd_ref(*ins, tdhs, *tfin)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("wants", [(0,), (0, 2), (1, 3, 6)],
                         ids=["x_pre", "x_pre_r", "b_c_h"])
def test_slstm_function_with_some_inputs_requiring_grad(wants):
    """Under autograd with only some inputs requiring a gradient (x_pre
    alone is FedLoRA's case: b and r frozen) the Function's gradients of
    those inputs equal the full backward's."""
    arrs, dhs, _ = _inputs(2, 6, 2, 16, "float32", "state")
    ins, tdhs = _torch(arrs, dhs, "float32")
    args = [t.clone().requires_grad_() if i in wants else t
            for i, t in enumerate(ins)]
    hs, _ = slstm(*args)
    got = torch.autograd.grad(hs, [args[i] for i in wants], tdhs)
    full = ref.slstm_bwd_ref(*ins, tdhs)
    assert all(torch.equal(g, full[i]) for g, i in zip(got, wants))


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _model():
    """xlstm-350m SMOKE in f32: (reference config, port config, reference
    params, port params), the port's init carried by the converter."""
    jcfg = j_get_config(ARCH, smoke=True).replace(dtype="float32")
    tcfg = t_get_config(ARCH, smoke=True).replace(dtype="float32")
    params = untie_params(tcfg, init_params(
        tcfg, torch.Generator().manual_seed(0)))
    return jcfg, tcfg, jax.tree.map(jnp.asarray, to_jax_params(params)), params


@pytest.mark.parametrize("block", ["mlstm", "slstm"])
def test_block_gradients_match_jax_grad(block):
    """jax.grad of Σ y·w + Σ_k Σ state_k·w_k through the reference's
    ``mlstm_forward`` (b0: two 16-token chunks and the 8-token tail) or
    ``slstm_forward`` (b3) from a nonzero state, against torch.autograd of
    the port's (the sLSTM's recurrence through the Function's plain
    backward): the input's and every parameter's gradient within 1e-5 of
    its largest magnitude, in f32."""
    jcfg, tcfg, jp, tp = _model()
    j = 0 if block == "mlstm" else 3
    jfwd, tfwd = ((j_ssm.mlstm_forward, ssm.mlstm_forward) if j == 0
                  else (j_ssm.slstm_forward, ssm.slstm_forward))
    init = j_ssm.mlstm_init_state if j == 0 else j_ssm.slstm_init_state
    jc = jax.tree.map(lambda a: a[0], jp["units"][f"b{j}"]["core"])
    tc = tree.tree_map(lambda a: a[0], tp["units"][f"b{j}"]["core"])
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 40, 64)).astype(np.float32)
    st = {k: np.asarray(v) for k, v in init(jcfg, 2).items()}
    for k in sorted(st):
        st[k] = (rng.standard_normal(st[k].shape) * 0.5).astype(np.float32)
    if j == 3:
        st["n"] = np.abs(st["n"]) + 1.0
    w = rng.standard_normal((2, 40, 64)).astype(np.float32)
    ws = {k: rng.standard_normal(v.shape).astype(np.float32)
          for k, v in st.items()}

    def loss(p, x, state):
        y, out = jfwd(jcfg, p, x, state)
        return jnp.sum(y * w) + sum(jnp.sum(out[k] * ws[k]) for k in ws)
    jg, jgx, jgs = jax.grad(loss, argnums=(0, 1, 2))(
        jc, jnp.asarray(x), {k: jnp.asarray(v) for k, v in st.items()})
    tp_ = {k: v.clone().requires_grad_() for k, v in tc.items()}
    tx = torch.from_numpy(x).requires_grad_()
    ts = {k: torch.from_numpy(v.copy()).requires_grad_()
          for k, v in st.items()}
    y, out = tfwd(tcfg, tp_, tx, ts)
    tl = (y * torch.from_numpy(w)).sum() + sum(
        (out[k] * torch.from_numpy(ws[k])).sum() for k in ws)
    names = sorted(tp_)
    keys = sorted(ts)
    grads = torch.autograd.grad(tl, [tp_[k] for k in names] + [tx]
                                + [ts[k] for k in keys])
    for k, g in zip(names, grads):
        _assert_grad(g, jg[k], 1e-5, k)
    _assert_grad(grads[len(names)], jgx, 1e-5, "x")
    for k, g in zip(keys, grads[len(names) + 1:]):
        _assert_grad(g, jgs[k], 1e-5, f"state {k}")


# ---------------------------------------------------------------------------
# FedAvg and FedLoRA on xlstm-350m
# ---------------------------------------------------------------------------

def _max_leaf_err(got, want):
    """Largest |Δ| over the leaves, each over max(max|leaf|, 1)."""
    got = jax.tree.leaves(to_jax_params(got))
    want = jax.tree.leaves(want)
    assert len(got) == len(want)
    return max(float(np.abs(_f32(a) - _f32(b)).max())
               / max(float(np.abs(_f32(b)).max()), 1.0)
               for a, b in zip(got, want))


@pytest.mark.parametrize("algorithm", ["fedavg", "fedlora"])
def test_first_order_round_on_xlstm_matches_reference(algorithm):
    """One FedAvg round (SGD, lr 1e-2) or one FedLoRA round (rank 4,
    adapters on the mLSTM blocks' wq and wv with a nonzero B) of M=2
    clients at mask (1, 0.5) and η_g 0.3 on xlstm-350m SMOKE (8 layers, S
    40), against the reference's jitted round: every leaf within 1e-4 of
    max(its largest magnitude, 1); the leaves that move are the
    reference's (FedAvg: every leaf; FedLoRA: A and B of every target, the
    base untouched). Every sLSTM block lies behind b0's adapters, so
    FedLoRA's gradient runs back through all of them."""
    jcfg, tcfg, jp, tp = _model()
    rng = np.random.default_rng(4)
    toks = rng.integers(0, jcfg.vocab_size, (2, 1, 40))
    labels = np.roll(toks, -1, -1)
    jb = {"tokens": jnp.asarray(toks, jnp.int32),
          "labels": jnp.asarray(labels, jnp.int32)}
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(
        labels)}
    mask = np.array([1.0, 0.5], np.float32)
    if algorithm == "fedavg":
        want = jax.jit(lambda p, b, m: jbase.fedavg_round(
            jcfg, p, b, m, 1e-2, eta_g=0.3))(jp, jb, jnp.asarray(mask))
        got = tbase.fedavg_round(tcfg, tp, tb, torch.from_numpy(mask), 1e-2,
                                 eta_g=0.3)
        start = jp
    else:
        lora = joptim.init_lora(jcfg, jp, 4, jax.random.PRNGKey(2))
        assert set(lora["units"]) == {"b0", "b1", "b2"}
        assert all(set(lora["units"][k]["core"]) == {"wq", "wv"}
                   for k in lora["units"])
        lora = jax.tree.map(lambda a: jnp.asarray(
            rng.normal(size=a.shape) * 0.05, a.dtype), lora)
        want = jax.jit(lambda lo, b, m: jbase.fedlora_round(
            jcfg, jp, lo, b, m, 1e-2, 16.0, eta_g=0.3))(lora, jb,
                                                        jnp.asarray(mask))
        before = [a.clone() for a in tree.leaves(tp)]
        got = tbase.fedlora_round(tcfg, tp, from_jax_params(lora), tb,
                                  torch.from_numpy(mask), 1e-2, 16.0,
                                  eta_g=0.3)
        assert all(torch.equal(a, b) for a, b in zip(tree.leaves(tp),
                                                     before))
        start = lora
    assert _max_leaf_err(got, want) <= 1e-4
    moved = jax.tree.map(lambda a, b: bool((_f32(a) != _f32(b)).any()),
                         to_jax_params(got), start)
    assert moved == jax.tree.map(lambda a, b: bool(
        (_f32(a) != _f32(b)).any()), want, start)
    assert all(jax.tree.leaves(moved))


@pytest.mark.parametrize("algorithm", ["fedavg", "fedlora"])
def test_driver_runs_xlstm_first_order_on_the_cpu(algorithm):
    """``launch.train --arch xlstm-350m --smoke --device cpu --algorithm
    fedavg|fedlora`` (M=2, seq 40, 2 rounds): finite losses; FedAvg moves
    every parameter, FedLoRA only its adapters (its B from zero, so each
    target's B moves) and leaves the base as it was."""
    run = t_train.setup(["--arch", ARCH, "--smoke", "--device", "cpu",
                         "--clients", "2", "--batch", "1", "--seq", "40",
                         "--rounds", "2", "--algorithm", algorithm])
    before = [a.clone() for a in tree.leaves(run.params)]
    res, _ = t_train.run_engine(run, log=None)
    assert len(res.round_loss) == 2 and np.isfinite(res.round_loss).all()
    moved = [not torch.equal(a, b) for a, b in zip(tree.leaves(res.params),
                                                   before)]
    if algorithm == "fedavg":
        assert all(moved)
    else:
        assert not any(moved)
        init = tengine.get_algorithm("fedlora").init_state(
            run.cfg, run.sfl, run.params, None)
        lora = res.state["units"]
        assert sorted(lora) == ["b0", "b1", "b2"]
        for k in lora:
            for t in ("wq", "wv"):
                assert not torch.equal(lora[k]["core"][t]["B"],
                                       init["units"][k]["core"][t]["B"])
