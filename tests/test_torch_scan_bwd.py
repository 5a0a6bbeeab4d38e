"""Port parity: the selective scan's gradient (``kernels/ref.py:
selective_scan_bwd_ref``, the plain version of
``csrc/selective_scan_bwd.cu``, and ``kernels/selective_scan.py``'s
autograd Function), the Mamba block's parameter gradients, and FedAvg and
FedLoRA rounds on jamba-1.5-large-398b SMOKE, against the JAX package on
the CPU.

Tolerances. f32: each gradient within 1e-5 of its largest magnitude (the
reference's associative scan forms h in another order, and the sums run
in another order); bf16: within 2^-7 of it (dx and dz are rounded to
bf16, and so are do = dy·silu(z) and dy·T(o) before them, on both sides,
where an f32 difference can move a rounding). Rounds within 1e-4 of every
leaf, in f32 at capacity factor 2.0 (4 experts top-2: no token drops),
on one unit of the pattern (8 layers).
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
from repro.models import init_params as j_init
from repro.models import ssm as j_ssm
from repro.models import untie_params as j_untie
from repro_torch.configs import get_config as t_get_config
from repro_torch.core import baselines as tbase
from repro_torch.kernels import ref
from repro_torch.kernels.selective_scan import selective_scan
from repro_torch.models import ssm
from repro_torch.models.convert import from_jax_params, to_jax_params
from repro_torch.utils import tree

ARCH = "jamba-1.5-large-398b"
B = 2
NAMES = ("x", "dt", "z", "Bc", "Cc", "A_log", "D", "dt_bias", "h0")
CASES = [(16, 0.0), (16, 0.5), (1, 0.5)]
CASE_IDS = ["zero_h0", "h0", "one_token"]


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


def _tol(dtype):
    return 1e-5 if dtype == "float32" else 2.0 ** -7


def _inputs(n, h0_scale, dtype, d_in=24, N=4, seed=5):
    """The scan's inputs as numpy arrays (x, z rounded to ``dtype``), and
    its cotangents dy (in ``dtype``) and dh_last."""
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    x = normal(B, n, d_in) * 2.0
    x = x / (1.0 + np.exp(-x))                                # silu
    A_log = np.log(np.broadcast_to(np.arange(1, N + 1, dtype=np.float32),
                                   (d_in, N))) + 0.1 * normal(d_in, N)
    bias = np.float32(np.log(np.expm1(0.01))) + normal(d_in)
    arrs = [x, normal(B, n, d_in), normal(B, n, d_in), normal(B, n, N),
            normal(B, n, N), A_log.astype(np.float32),
            1.0 + 0.1 * normal(d_in), bias, normal(B, d_in, N) * h0_scale]
    dy, dh_last = normal(B, n, d_in), normal(B, d_in, N)
    rnd = {0, 2}                               # x and z in the model type
    if dtype == "bfloat16":
        bf = jnp.bfloat16
        arrs = [np.asarray(jnp.asarray(a, bf).astype(jnp.float32))
                if i in rnd else a for i, a in enumerate(arrs)]
        dy = np.asarray(jnp.asarray(dy, bf).astype(jnp.float32))
    return arrs, dy, dh_last


def _torch(arrs, dy, dtype):
    td = getattr(torch, dtype)
    ins = [torch.from_numpy(np.array(a)).to(td if i in (0, 2)
                                            else torch.float32)
           for i, a in enumerate(arrs)]
    return ins, torch.from_numpy(dy).to(td)


def _jax_chain(dtype):
    """The reference's chain from the scan's inputs: the lines of
    ``_mamba_ssm_params`` after x_proj's split (softplus of dt + dt_bias,
    A = -exp(A_log), dA and dBx), ``_ssm_scan_chunk``, the C contraction
    and the D and silu(z) gate of ``mamba_forward`` (one chunk)."""
    jd = jnp.dtype(dtype)

    def chain(x, dt, z, Bc, Cc, A_log, D, dt_bias, h0):
        x, z = x.astype(jd), z.astype(jd)
        delta = jax.nn.softplus(dt + dt_bias)
        A = -jnp.exp(A_log)
        dA = jnp.exp(delta[..., None] * A[None, None])
        dBx = (delta * x.astype(jnp.float32))[..., None] * Bc[:, :, None, :]
        h_all, h_last = j_ssm._ssm_scan_chunk(dA.swapaxes(0, 1),
                                              dBx.swapaxes(0, 1), h0)
        y = jnp.einsum("lbdn,bln->bld", h_all, Cc)
        y = (y + x.astype(jnp.float32) * D).astype(jd)
        return y * jax.nn.silu(z), h_last
    return chain


# ---------------------------------------------------------------------------
# the plain backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,h0_scale", CASES, ids=CASE_IDS)
def test_scan_bwd_ref_matches_autograd_of_the_plain_forward(n, h0_scale,
                                                            dtype):
    """selective_scan_bwd_ref against torch.autograd of
    selective_scan_ref (the same forward, differentiated op by op), with
    nonzero dy and dh_last; and the autograd Function on CPU tensors
    (``selective_scan`` under autograd) returns selective_scan_bwd_ref's
    gradients exactly."""
    arrs, dy, dh_last = _inputs(n, h0_scale, dtype)
    ins, tdy = _torch(arrs, dy, dtype)
    tdh = torch.from_numpy(dh_last)
    got = ref.selective_scan_bwd_ref(*ins, tdy, tdh)
    req = [t.clone().requires_grad_() for t in ins]
    y, h = ref.selective_scan_ref(*req)
    want = torch.autograd.grad((y, h), req, (tdy, tdh))
    for name, g, w, t in zip(NAMES, got, want, ins):
        assert g.dtype == t.dtype and g.shape == t.shape
        _assert_grad(g, w, _tol(dtype), name)
    req = [t.clone().requires_grad_() for t in ins]
    y, h = selective_scan(*req)
    fn = torch.autograd.grad((y, h), req, (tdy, tdh))
    assert all(torch.equal(a, b) for a, b in zip(fn, got))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,h0_scale", CASES, ids=CASE_IDS)
def test_scan_bwd_ref_matches_jax_vjp_of_the_reference_chain(n, h0_scale,
                                                             dtype):
    """selective_scan_bwd_ref against jax.vjp of the reference's chain
    (``_jax_chain``) at the same inputs and cotangents: zero and nonzero
    h0, one token; f32 within 1e-5 and bf16 within 2^-7 of each
    gradient's largest magnitude."""
    arrs, dy, dh_last = _inputs(n, h0_scale, dtype)
    ins, tdy = _torch(arrs, dy, dtype)
    got = ref.selective_scan_bwd_ref(*ins, tdy, torch.from_numpy(dh_last))
    jd = jnp.dtype(dtype)
    jins = [jnp.asarray(a) for a in arrs]
    (y, _), vjp = jax.vjp(_jax_chain(dtype), *jins)
    assert y.dtype == jd
    want = vjp((jnp.asarray(dy, jd), jnp.asarray(dh_last)))
    for name, g, w in zip(NAMES, got, want):
        _assert_grad(g, w, _tol(dtype), name)


@functools.lru_cache(maxsize=None)
def _block(dtype="float32"):
    """The first Mamba block of jamba SMOKE: (reference config, port
    config, reference core params, port core params)."""
    jcfg = j_get_config(ARCH, smoke=True).replace(dtype=dtype, n_layers=8)
    tcfg = t_get_config(ARCH, smoke=True).replace(dtype=dtype, n_layers=8)
    params = j_untie(jcfg, jax.jit(functools.partial(j_init, jcfg))(
        jax.random.PRNGKey(0)))
    core = jax.tree.map(lambda a: a[0], params["units"]["b0"]["core"])
    return jcfg, tcfg, core, from_jax_params(core)


def test_scan_chain_through_x_proj_matches_jax_vjp():
    """The scan under autograd as ``models/ssm.py:_scan`` calls it (x_proj
    in the model type, the dt_proj product in f32, B and C read as slices
    of x_dbl) against jax.vjp of ``_mamba_ssm_params`` ->
    ``_ssm_scan_chunk`` -> the C contraction -> the gate, with respect to
    the post-conv activation, x_proj, dt_proj, A_log, D, dt_bias, z and
    h0: f32 within 1e-5 of each largest magnitude."""
    jcfg, tcfg, jc, tc = _block()
    d_in, N, _, _, _ = j_ssm.mamba_dims(jcfg)
    rng = np.random.default_rng(3)
    xs = (rng.standard_normal((B, 16, d_in)) * 2.0).astype(np.float32)
    z = rng.standard_normal((B, 16, d_in)).astype(np.float32)
    h0 = (rng.standard_normal((B, d_in, N)) * 0.5).astype(np.float32)
    dy = rng.standard_normal((B, 16, d_in)).astype(np.float32)
    dh = rng.standard_normal((B, d_in, N)).astype(np.float32)
    keys = ("x_proj", "dt_proj", "A_log", "D", "dt_bias")

    def chain(xs, z, h0, *leaves):
        p = dict(zip(keys, leaves))
        dA, dBx, Cc = j_ssm._mamba_ssm_params(jcfg, p, xs)
        h_all, h_last = j_ssm._ssm_scan_chunk(dA.swapaxes(0, 1),
                                              dBx.swapaxes(0, 1), h0)
        y = jnp.einsum("lbdn,bln->bld", h_all, Cc)
        return (y + xs * p["D"]) * jax.nn.silu(z), h_last
    jin = [jnp.asarray(a) for a in (xs, z, h0)] + [jc[k] for k in keys]
    _, vjp = jax.vjp(chain, *jin)
    want = vjp((jnp.asarray(dy), jnp.asarray(dh)))
    tin = [torch.from_numpy(a).requires_grad_() for a in (xs, z, h0)] + [
        tc[k].clone().requires_grad_() for k in keys]
    p = dict(zip(keys, tin[3:]))
    y, h = ssm._scan(tcfg, p, tin[0], tin[1], tin[2])
    got = torch.autograd.grad((y, h), tin, (torch.from_numpy(dy),
                                            torch.from_numpy(dh)))
    for name, g, w in zip(("xs", "z", "h0") + keys, got, want):
        _assert_grad(g, w, 1e-5, name)


def test_mamba_block_gradients_match_jax_grad():
    """jax.grad of Σ y·w + Σ h·w_h through ``repro.models.ssm.mamba_forward``
    (in_proj, the causal conv, x_proj, the chunked scan over two 16-token
    chunks and an 8-token tail, the gate, out_proj) from a nonzero h,
    against torch.autograd of the port's ``mamba_forward`` (the scan's
    backward its plain version): the input's and every parameter's
    gradient within 1e-5 of its largest magnitude, in f32."""
    jcfg, tcfg, jc, tc = _block()
    d_in, N, _, _, _ = j_ssm.mamba_dims(jcfg)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((B, 40, jcfg.d_model)).astype(np.float32)
    h0 = (rng.standard_normal((B, d_in, N)) * 0.5).astype(np.float32)
    w = rng.standard_normal((B, 40, jcfg.d_model)).astype(np.float32)
    wh = rng.standard_normal((B, d_in, N)).astype(np.float32)

    def loss(p, x, h0):
        state = j_ssm.mamba_init_state(jcfg, B)
        state["h"] = h0
        y, st = j_ssm.mamba_forward(jcfg, p, x, state)
        return jnp.sum(y * w) + jnp.sum(st["h"] * wh)
    jg, jgx = jax.jit(jax.grad(loss, argnums=(0, 1)))(
        jc, jnp.asarray(x), jnp.asarray(h0))
    tp = {k: v.clone().requires_grad_() for k, v in tc.items()}
    tx = torch.from_numpy(x).requires_grad_()
    state = ssm.mamba_init_state(tcfg, B)
    state["h"] = torch.from_numpy(h0)
    y, st = ssm.mamba_forward(tcfg, tp, tx, state)
    tl = (y * torch.from_numpy(w)).sum() + (st["h"] * torch.from_numpy(
        wh)).sum()
    names = sorted(tp)
    grads = torch.autograd.grad(tl, [tp[k] for k in names] + [tx])
    for k, g in zip(names, grads):
        assert g.shape == tp[k].shape
        _assert_grad(g, jg[k], 1e-5, k)
    _assert_grad(grads[-1], jgx, 1e-5, "x")


# ---------------------------------------------------------------------------
# FedAvg and FedLoRA on jamba
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jamba():
    """jamba SMOKE at one unit (8 layers) in f32, capacity factor 2.0."""
    cfgs = []
    for get in (j_get_config, t_get_config):
        cfg = get(ARCH, smoke=True).replace(dtype="float32", n_layers=8)
        cfgs.append(cfg.replace(moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k)))
    jcfg, tcfg = cfgs
    params = j_untie(jcfg, jax.jit(functools.partial(j_init, jcfg))(
        jax.random.PRNGKey(0)))
    return jcfg, tcfg, params, from_jax_params(params)


def _max_leaf_err(got, want):
    """Largest |Δ| over the leaves, each over max(max|leaf|, 1)."""
    got = jax.tree.leaves(to_jax_params(got))
    want = jax.tree.leaves(want)
    assert len(got) == len(want)
    return max(float(np.abs(_f32(a) - _f32(b)).max())
               / max(float(np.abs(_f32(b)).max()), 1.0)
               for a, b in zip(got, want))


@pytest.mark.parametrize("algorithm", ["fedavg", "fedlora"])
def test_first_order_round_on_jamba_matches_reference(algorithm):
    """One FedAvg round (SGD, lr 1e-2) or one FedLoRA round (rank 4,
    adapters on the attention block's wq and wv with a nonzero B) of M=2
    clients at mask (1, 0.5) and η_g 0.3 on jamba SMOKE's first unit,
    against the reference's jitted round: every leaf within 1e-4 of
    max(its largest magnitude, 1); every leaf moved (FedLoRA: A and B of
    both targets, the base untouched). The gradient runs through the
    selective scan's plain backward."""
    jcfg, tcfg, jp, tp = _jamba()
    rng = np.random.default_rng(4)
    toks = rng.integers(0, jcfg.vocab_size, (2, 1, 16))
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
        assert set(lora["units"]) == {"b3"}
        assert set(lora["units"]["b3"]["core"]) == {"wq", "wv"}
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
    got_j = to_jax_params(got)
    moved = jax.tree.map(lambda a, b: bool((_f32(a) != _f32(b)).any()),
                         got_j, start)
    assert moved == jax.tree.map(lambda a, b: bool(
        (_f32(a) != _f32(b)).any()), want, start)
    if algorithm == "fedlora":
        assert all(jax.tree.leaves(moved))
    else:
        # dt_bias (softplus⁻¹(0.01) ≈ -4.6) moves by less than its ulp in
        # some blocks, on both sides; every other Mamba leaf moves
        for j, kind in enumerate(jcfg.block_pattern):
            if kind == "mamba":
                core = moved["units"][f"b{j}"]["core"]
                assert all(v for k, v in core.items() if k != "dt_bias")
