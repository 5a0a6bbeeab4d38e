"""Port parity: gradients through the port's differentiable kernel layer
(the flash-attention and RMSNorm autograd Functions, whose backward on the
CPU is the plain version in ``kernels/ref.py``) and through ``loss_fn``,
against ``torch.autograd`` through the plain forwards and against
``jax.grad``/``jax.vjp`` of the reference: its attention and norm oracles
(``repro.kernels.ref``), its einsum attention
(``repro.models.attention.gqa_attention``) and its ``loss_fn`` on the
SMOKE configs of olmo-1b, paper-opt-1.3b and qwen3-14b.

Tolerances, all f32: every gradient within 1e-5 of its own largest
magnitude (max |Δ| <= 1e-5·max|g| + 1e-9, the floor near f32 rounding of
a zero gradient; the sums run in other orders: the port's backward by its
explicit formulas, the reference by XLA's autodiff).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from one_torch_thread import one_torch_thread  # noqa: F401
from repro.configs import get_config as j_get_config
from repro.kernels import ref as jref
from repro.models import attention as j_attention
from repro.models import init_params as j_init
from repro.models import layers as j_layers
from repro.models import loss_fn as j_loss_fn
from repro.models import untie_params as j_untie
from repro_torch.configs import get_config as t_get_config
from repro_torch.core.baselines import _grads
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_pair
from repro_torch.models import attention as t_attention
from repro_torch.models import init_params, loss_fn, untie_params
from repro_torch.models.convert import from_jax_params, to_jax_params
from repro_torch.utils import tree

TOL = 1e-5


def assert_grad_close(got, want):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= TOL * float(np.abs(want).max()) + 1e-9, err


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32)).requires_grad_(True)


# (B, H, Hkv, S, d, causal, window): G = 1 and 4, d 64 and 128, causal,
# causal with a window, and a window alone
FLASH_CASES = [(1, 4, 4, 64, 64, True, 0),
               (1, 8, 2, 48, 128, True, 0),
               (2, 4, 1, 40, 64, True, 16),
               (1, 4, 4, 40, 128, True, 12),
               (1, 4, 1, 36, 64, False, 10)]


@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=[f"G{c[1] // c[2]}-d{c[4]}-"
                              f"{'causal' if c[5] else 'noncausal'}-w{c[6]}"
                              for c in FLASH_CASES])
def test_flash_attention_grad_matches_autograd_and_jax(case):
    """dq, dk, dv of the flash Function (the plain backward by its
    formulas, from the forward's lse) against torch.autograd through the
    plain forward and jax.vjp of the reference oracle, and the lse against
    the reference's log-sum-exp of the masked scores."""
    B, H, Hkv, S, d, causal, window = case
    rng = np.random.default_rng(S + d + H)
    q, k, v = (rng.normal(size=(B, h, S, d)).astype(np.float32)
               for h in (H, Hkv, Hkv))
    do = rng.normal(size=(B, H, S, d)).astype(np.float32)
    qkv = [_t(a) for a in (q, k, v)]
    out = flash_attention(*qkv, causal=causal, window=window)
    got = torch.autograd.grad(out, qkv, torch.from_numpy(do))
    qkv2 = [_t(a) for a in (q, k, v)]
    auto = torch.autograd.grad(
        ref.flash_attention_ref(*qkv2, causal, window), qkv2,
        torch.from_numpy(do))
    _, vjp = jax.vjp(lambda a, b, c: jref.flash_attention_ref(
        a, b, c, causal=causal, window=window), q, k, v)
    want = vjp(jnp.asarray(do))
    for g, a, w in zip(got, auto, want):
        assert_grad_close(g, a)
        assert_grad_close(g, w)
    o, lse = ref.flash_attention_ref(*(torch.from_numpy(a) for a in
                                       (q, k, v)), causal, window,
                                     return_lse=True)
    scores = jnp.einsum("bkgsd,bktd->bkgst",
                        q.reshape(B, Hkv, H // Hkv, S, d), k) / np.sqrt(d)
    ok = np.asarray(j_attention._mask(S, S, causal, window)) == 0
    want_lse = jax.nn.logsumexp(jnp.where(ok, scores, -1e30), axis=-1)
    assert_grad_close(lse, np.asarray(want_lse).reshape(B, H, S))


@pytest.mark.parametrize("G,d,window", [(1, 64, 0), (4, 128, 0),
                                        (4, 64, 20), (1, 128, 20)])
def test_gqa_attention_grad_matches_reference_einsum(G, d, window):
    """The port's attention layer under autograd (projections, RoPE, the
    flash Function) against jax.grad of the reference's einsum attention,
    with respect to the input and every projection, f32."""
    H = 4
    jcfg = j_get_config("olmo-1b", smoke=True).replace(
        d_model=96, n_heads=H, n_kv_heads=H // G, d_head=d,
        dtype="float32", sliding_window=window)
    tcfg = t_get_config("olmo-1b", smoke=True).replace(
        d_model=96, n_heads=H, n_kv_heads=H // G, d_head=d,
        dtype="float32", sliding_window=window)
    rng = np.random.default_rng(G + d + window)
    B, S, D = 2, 48, 96
    p = {"wq": rng.normal(size=(D, H * d)), "wk": rng.normal(
        size=(D, H // G * d)), "wv": rng.normal(size=(D, H // G * d)),
        "wo": rng.normal(size=(H * d, D))}
    p = {n: (w / np.sqrt(w.shape[0])).astype(np.float32)
         for n, w in p.items()}
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    dy = rng.normal(size=(B, S, D)).astype(np.float32)
    pos = np.tile(np.arange(S), (B, 1))

    def j_fn(pp, xx):
        return jnp.sum(j_attention.gqa_attention(jcfg, pp, xx, pos) * dy)
    want_p, want_x = jax.grad(j_fn, argnums=(0, 1))(
        {n: jnp.asarray(w) for n, w in p.items()}, jnp.asarray(x))
    tp = {n: _t(w) for n, w in p.items()}
    tx = _t(x)
    out = t_attention.gqa_attention(tcfg, tp, tx, torch.from_numpy(pos))
    names = sorted(tp)
    got = torch.autograd.grad(out, [tp[n] for n in names] + [tx],
                              torch.from_numpy(dy))
    for n, g in zip(names, got):
        assert_grad_close(g, want_p[n])
    assert_grad_close(got[-1], want_x)


@pytest.mark.parametrize("shape", [(3, 5, 64), (2, 7, 4, 128)])
def test_rmsnorm_grad_matches_autograd_and_jax(shape):
    """dx and dscale of the RMSNorm Function and of the pair Function (q
    and k, each its own scale) against torch.autograd through the plain
    norm and jax.vjp of the reference oracle and of the model's
    rms_norm_simple."""
    rng = np.random.default_rng(len(shape))
    D = shape[-1]
    x = (rng.normal(size=shape) * 3).astype(np.float32)
    xk = (rng.normal(size=shape[:-1] + (D,)) * 2).astype(np.float32)
    s = (1 + 0.5 * rng.normal(size=D)).astype(np.float32)
    sk = (1 + 0.5 * rng.normal(size=D)).astype(np.float32)
    dy = rng.normal(size=shape).astype(np.float32)
    dyk = rng.normal(size=shape).astype(np.float32)
    tx, ts = _t(x), _t(s)
    got = torch.autograd.grad(rmsnorm(tx, ts), (tx, ts),
                              torch.from_numpy(dy))
    tx2, ts2 = _t(x), _t(s)
    auto = torch.autograd.grad(ref.rmsnorm_ref(tx2, ts2), (tx2, ts2),
                               torch.from_numpy(dy))
    for oracle in (jref.rmsnorm_ref, j_layers.rms_norm_simple):
        _, vjp = jax.vjp(oracle, x, s)
        for g, a, w in zip(got, auto, vjp(jnp.asarray(dy))):
            assert_grad_close(g, a)
            assert_grad_close(g, w)
    pq = [_t(a) for a in (x, s, xk, sk)]
    yq, yk = rmsnorm_pair(*pq)
    got = torch.autograd.grad((yq, yk), pq, (torch.from_numpy(dy),
                                             torch.from_numpy(dyk)))
    _, vq = jax.vjp(jref.rmsnorm_ref, x, s)
    _, vk = jax.vjp(jref.rmsnorm_ref, xk, sk)
    want = (*vq(jnp.asarray(dy)), *vk(jnp.asarray(dyk)))
    for g, w in zip(got, want):
        assert_grad_close(g, w)


@pytest.mark.parametrize("arch", ["olmo-1b", "paper-opt-1.3b", "qwen3-14b"])
def test_loss_grad_matches_jax(arch):
    """The port's gradient of loss_fn (torch.autograd.grad through the
    whole SMOKE model, f32, labels with ignored positions) against
    jax.grad of the reference's, leaf by leaf."""
    jcfg = j_get_config(arch, smoke=True).replace(dtype="float32")
    tcfg = t_get_config(arch, smoke=True).replace(dtype="float32")
    params = j_untie(jcfg, j_init(jcfg, jax.random.PRNGKey(1)))
    rng = np.random.default_rng(3)
    toks = rng.integers(0, jcfg.vocab_size, size=(2, 24)).astype(np.int32)
    labels = np.roll(toks, -1, axis=-1)
    labels[0, :3] = -1
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    want = jax.jit(jax.grad(lambda p: j_loss_fn(jcfg, p, jb)))(params)
    tb = {"tokens": torch.from_numpy(toks).long(),
          "labels": torch.from_numpy(labels).long()}
    got = _grads(lambda p: loss_fn(tcfg, p, tb), from_jax_params(params))
    got_l, want_l = tree.leaves(to_jax_params(got)), jax.tree.leaves(want)
    assert len(got_l) == len(want_l)
    for g, w in zip(got_l, want_l):
        assert_grad_close(g, w)


@pytest.mark.parametrize("arch", ["olmo-1b", "qwen3-14b"])
def test_cpu_model_gradient_reaches_every_leaf(arch):
    """Under autograd a CPU model no longer cuts the gradient: every
    parameter leaf, the attention projections and the qk-norm scales
    below the first attention included, gets a nonzero gradient."""
    cfg = t_get_config(arch, smoke=True).replace(dtype="float32")
    params = untie_params(cfg, init_params(
        cfg, torch.Generator().manual_seed(0)))
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 16)))
    g = _grads(lambda p: loss_fn(cfg, p, {"tokens": toks,
                                          "labels": toks.roll(-1, -1)}),
               params)
    leaves, _ = tree.flatten(g)
    assert len(leaves) == len(tree.leaves(params))
    for leaf in leaves:
        assert bool(torch.isfinite(leaf).all())
        assert float(leaf.abs().max()) > 0
    if cfg.qk_norm:
        assert float(g["units"]["b0"]["core"]["q_norm"].abs().max()) > 0


@pytest.mark.parametrize("cut", [1, 2])
def test_loss_fn_gradient_equals_the_split_composition(cut):
    """loss_fn's units come from one unbind of each stacked leaf, not from
    split_params' two slices; its loss and gradient at any cut equal the
    client/server composition's (split_params, client_forward,
    server_forward) bit for bit, and a cut outside [1, n_units] raises."""
    from repro_torch.models import (client_forward, forward_from_cut,
                                    server_forward, split_params)
    cfg = t_get_config("paper-opt-1.3b", smoke=True).replace(
        dtype="float32")
    params = untie_params(cfg, init_params(
        cfg, torch.Generator().manual_seed(2)))
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 16)))
    b = {"tokens": toks, "labels": toks.roll(-1, -1)}

    def composed(p):
        cp, sp = split_params(cfg, p, cut)
        return server_forward(cfg, sp, client_forward(cfg, cp, b), b)

    assert torch.equal(forward_from_cut(cfg, params, b, cut),
                       composed(params))
    got = _grads(lambda p: forward_from_cut(cfg, p, b, cut), params)
    want = _grads(composed, params)
    for g, w in zip(tree.leaves(got), tree.leaves(want)):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="cut_units"):
        forward_from_cut(cfg, params, b, cfg.n_units + 1)
