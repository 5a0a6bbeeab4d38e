"""Port parity: MLA and deepseek-v2-236b (the MLA half of
``models/attention.py``, its branches of ``models/transformer.py``, the
shared experts of ``models/moe.py``, the flash function's plain version at
d_v != d_qk) against the JAX package on deepseek-v2-236b SMOKE (4 layers,
d_model 64, 4 heads of 16 nope + 8 rope dims and v 16, kv_lora 16,
q_lora 24, 8 experts top-2, 1 shared), with the reference's parameters
carried across by the converter.

Tolerances (f32 unless named). The plain flash function at (d_qk, d_v) =
(24, 16) against the reference's MLA attention core (its two score
einsums, softmax, P·V) within 1e-6 absolute (|o| <= ~2; sums in another
order), its lse within 1e-6 of a logsumexp of the same scores; at d_v =
d_qk it is bit-equal to the formula it had before d_v was free.
``mla_attention`` within 1e-5 of max|y| (the flash function scores over
the 24 dims in one sum where the reference adds two), bf16 within 2^-5 of
max|y| (the reference casts the probabilities to bf16 before P·V, the
flash function keeps them in f32: tests/test_torch_models.py). MoE with
the shared expert: routing exact (each case first asserts that the k-th
and (k+1)-th routing probabilities of every token are more than 1e-6
apart, as tests/test_torch_moe.py does), aux within 1e-6, the output within
1e-5 of max|y|. The forward halves, the loss, one MU-SplitFed round
(counter noise, seed replay), prefill, 8 decode steps and their caches:
within 1e-4 of max(the quantity's largest magnitude, 1). The port's own
prefill and decode against its own logits_fn within 1e-4 of that scale, at
a capacity where no token drops. Greedy tokens equal. The converter keeps
every bit of the bf16 MLA parameters and cache.
"""
import dataclasses
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
from repro.models import prefill as j_prefill
from repro.models import server_forward as j_server
from repro.models import split_params as j_split
from repro.models import untie_params as j_untie
from repro.models.attention import mla_attention as j_mla_attention
from repro.models.moe import apply_moe as j_apply_moe
from repro_torch.configs import SFLConfig as TSFL
from repro_torch.configs import get_config as t_get_config
from repro_torch.core import prng
from repro_torch.core.splitfed import mu_splitfed_round
from repro_torch.kernels import ref
from repro_torch.launch import serve
from repro_torch.models import (attention, client_forward, decode_step,
                                init_cache, init_params, logits_fn, loss_fn,
                                moe, prefill, server_forward, split_params,
                                untie_params)
from repro_torch.models.convert import from_jax_params, to_jax_params
from repro_torch.utils import tree

ARCH = "deepseek-v2-236b"
B, S, GEN = 2, 16, 8
GAP = 1e-6


@functools.lru_cache(maxsize=None)
def _params(dtype):
    jcfg = j_get_config(ARCH, smoke=True).replace(dtype=dtype)
    params = j_untie(jcfg, jax.jit(functools.partial(j_init, jcfg))(
        jax.random.PRNGKey(0)))
    return params, from_jax_params(params)


def _model(dtype="float32", capacity_factor=None):
    """(reference config, port config, reference params, port params); the
    parameters are made once a dtype (the capacity factor changes no
    parameter)."""
    jcfg = j_get_config(ARCH, smoke=True).replace(dtype=dtype)
    tcfg = t_get_config(ARCH, smoke=True).replace(dtype=dtype)
    if capacity_factor is not None:
        jcfg = jcfg.replace(moe=dataclasses.replace(
            jcfg.moe, capacity_factor=capacity_factor))
        tcfg = tcfg.replace(moe=dataclasses.replace(
            tcfg.moe, capacity_factor=capacity_factor))
    return (jcfg, tcfg) + _params(dtype)


@functools.lru_cache(maxsize=None)
def _jit(fn, cfg, **kw):
    """The reference's ``fn`` for ``cfg``, jitted once per module (eager
    jax runs these MoE functions about 10x slower than their compile)."""
    return jax.jit(functools.partial(fn, cfg, **kw))


@functools.lru_cache(maxsize=None)
def _tokens():
    return np.random.default_rng(1).integers(
        0, 256, (B, S + GEN)).astype(np.int32)


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _assert_rel(got, want, tol):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1.0)


def _assert_tree(got, want, tol):
    got = to_jax_params(got)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.dtype == b.dtype
        _assert_rel(a, b, tol)


def _layer0(params, part):
    return jax.tree.map(lambda a: a[0], params["units"]["b0"][part])


def _x(dtype, N=S, skew=0.0, seed=7):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, N, 64))
         + skew * rng.standard_normal(64)).astype(np.float32)
    return (jnp.asarray(x, dtype=jnp.dtype(dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


@pytest.mark.parametrize("causal", [True, False])
def test_flash_ref_with_a_narrower_v_matches_the_mla_core(causal):
    """flash_attention_ref at (d_qk, d_v) = (24, 16), H = Hkv = 4, against
    the reference's MLA core (copied from
    ``repro.models.attention.mla_attention``: the nope and rope score
    einsums in f32, scaled by 1/√24, masked, softmax, P·V), and its lse
    against a logsumexp of those scores. At d_v = d_qk it equals the
    formula it had before d_v was free, bit for bit."""
    rng = np.random.default_rng(3)
    q, k = (rng.standard_normal((B, 4, S, 24)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((B, 4, S, 16)).astype(np.float32)
    jq, jk, jv = (jnp.asarray(a).swapaxes(1, 2) for a in (q, k, v))
    scores = (jnp.einsum("bshd,bthd->bhst", jq[..., :16], jk[..., :16],
                         preferred_element_type=jnp.float32)
              + jnp.einsum("bshd,bthd->bhst", jq[..., 16:], jk[..., 16:],
                           preferred_element_type=jnp.float32)
              ) * (1.0 / jnp.sqrt(24.0).astype(jnp.float32))
    if causal:
        scores = scores + jnp.where(jnp.tril(jnp.ones((S, S), bool)), 0.0,
                                    -1e30)
    want = jnp.einsum("bhst,bthd->bhsd", jax.nn.softmax(scores, -1), jv)
    got, lse = ref.flash_attention_ref(*map(torch.from_numpy, (q, k, v)),
                                       causal, 0, return_lse=True)
    assert got.shape == (B, 4, S, 16)
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-6
    assert np.abs(lse.numpy() - np.asarray(jax.nn.logsumexp(scores, -1))
                  ).max() <= 1e-6
    tq, tk, tv = map(torch.from_numpy, (q, k, q))
    qg = tq.reshape(B, 4, 1, S, 24)
    s = torch.einsum("bkgsd,bktd->bkgst", qg, tk) / np.sqrt(24)
    ok = ref._attention_mask(S, causal, 0, tq.device)
    p = torch.softmax(torch.where(ok, s, torch.full_like(s, -1e30)), -1)
    before = torch.einsum("bkgst,bktd->bkgsd", p, tv).reshape(B, 4, S, 24)
    assert torch.equal(ref.flash_attention_ref(tq, tk, tv, causal, 0),
                       before)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_attention_matches_reference(dtype):
    """The first layer's mla_attention on (2, 16, 64) inputs: f32 within
    1e-5 of max|y|, bf16 within 2^-5 of max|y|."""
    jcfg, tcfg, jp, tp = _model(dtype)
    jcore, tcore = _layer0(jp, "core"), tree.tree_map(
        lambda a: a[0], tp["units"]["b0"]["core"])
    jx, tx = _x(dtype)
    pos = np.broadcast_to(np.arange(S), (B, S))
    want = _f32(_jit(j_mla_attention, jcfg)(jcore, jx, jnp.asarray(pos)))
    got = attention.mla_attention(tcfg, tcore, tx, torch.from_numpy(
        pos.copy()))
    assert got.dtype == tx.dtype
    tol = 1e-5 if dtype == "float32" else 2.0 ** -5
    assert np.abs(_f32(got) - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("capacity_factor", [1.25, 4.0])
def test_apply_moe_with_a_shared_expert_matches_reference(capacity_factor):
    """deepseek SMOKE's MoE block (8 experts top-2 and one shared expert of
    width 32) at the default capacity (tokens dropped) and at 4.0 (none):
    indices exact, aux within 1e-6, the output within 1e-5 of max|y|; the
    shared expert's weights are there and move the output."""
    jcfg, tcfg, jp, tp = _model("float32", capacity_factor)
    jffn = _layer0(jp, "ffn")
    tffn = tree.tree_map(lambda a: a[0], tp["units"]["b0"]["ffn"])
    assert sorted(tffn["shared"]) == ["wg", "wi", "wo"]
    assert tuple(tffn["shared"]["wi"].shape) == (64, 32)
    jx, tx = _x("float32", N=32, skew=1.5)
    probs = jax.nn.softmax(jx @ jffn["router"], -1)
    s = np.sort(np.asarray(probs, np.float64), -1)[..., ::-1]
    assert float((s[..., 1] - s[..., 2]).min()) > GAP
    _, t_idx, _ = moe.route(tcfg, tffn, tx)
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(
        jax.lax.top_k(probs, 2)[1]))
    _, kept = moe.dispatch_slots(t_idx, 8, moe.capacity(tcfg, 32))
    assert bool(kept.all()) == (capacity_factor == 4.0)
    want, j_aux = _jit(j_apply_moe, jcfg)(jffn, jx)
    got, aux = moe.apply_moe(tcfg, tffn, tx)
    want = np.asarray(want)
    assert abs(float(aux) - float(j_aux)) <= 1e-6
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    unshared, _ = moe.apply_moe(tcfg.replace(moe=dataclasses.replace(
        tcfg.moe, n_shared=0)), tffn, tx)
    assert float((got - unshared).abs().max()) > 1e-3


def _batches(n=2, seed=3):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 256, (n, 1, S)).astype(np.int32)
    labels = np.roll(toks, -1, -1)
    j = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    t = {"tokens": torch.from_numpy(toks.astype(np.int64)),
         "labels": torch.from_numpy(labels.astype(np.int64))}
    return j, t


def test_forward_halves_and_loss_match_reference():
    """client_forward's h and aux, server_forward's loss, and loss_fn (the
    port's one pass over the units) against the reference's
    server_forward at the default cut (2 of 4 units), within 1e-4 of
    max(|·|, 1)."""
    jcfg, tcfg, jp, tp = _model()
    jb, tb = _batches(n=1)
    jb = {k: v[0] for k, v in jb.items()}
    tb = {k: v[0] for k, v in tb.items()}
    jc, js = j_split(jcfg, jp, 2)
    tc, ts = split_params(tcfg, tp, 2)
    jh, th = _jit(j_client, jcfg)(jc, jb), client_forward(tcfg, tc, tb)
    _assert_rel(th["h"], jh["h"], 1e-4)
    assert float(jh["aux"]) > 0.5
    _assert_rel(th["aux"], jh["aux"], 1e-4)
    want = _jit(j_server, jcfg)(js, jh, jb)
    _assert_rel(server_forward(tcfg, ts, th, tb), want, 1e-4)
    _assert_rel(loss_fn(tcfg, tp, tb), want, 1e-4)


def test_mu_splitfed_round_matches_reference():
    """One MU-SplitFed round (counter noise, seed replay, M=2 at weights 1
    and 0.5, τ=2, P=1) over every MLA, norm, router, expert and shared
    expert leaf: parameters and metrics within 1e-4."""
    jcfg, tcfg, jp, tp = _model()
    kw = dict(n_clients=2, tau=2, n_perturbations=1, cut_units=2,
              perturbation_dist="counter")
    jb, tb = _batches()
    mask = np.array([1.0, 0.5], np.float32)
    want_p, want_m = jax.jit(functools.partial(
        j_round, jcfg, JSFL(**kw), aggregation="seed_replay"))(
        jp, jb, jnp.asarray(mask), jax.random.PRNGKey(5))
    got_p, got_m = mu_splitfed_round(
        tcfg, TSFL(**kw), tp, tb, torch.from_numpy(mask), prng.PRNGKey(5),
        aggregation="seed_replay")
    _assert_tree(got_p, want_p, 1e-4)
    for f in want_m._fields:
        _assert_rel(getattr(got_m, f), getattr(want_m, f), 1e-4)


def test_init_cache_prefill_and_decode_match_reference():
    """init_cache's MLA layout ({"c_kv" (4, B, L, 16), "k_rope" (4, B, L,
    8)}, zeros) equals the reference's; prefill's last logits and cache,
    then 8 decode steps' logits and caches (the reference's
    decode_step_jit), within 1e-4."""
    jcfg, tcfg, jp, tp = _model()
    want = j_init_cache(jcfg, B, S + GEN)
    got = init_cache(tcfg, B, S + GEN, device="cpu")
    assert tuple(got["b0"]["c_kv"].shape) == (4, B, S + GEN, 16)
    assert tuple(got["b0"]["k_rope"].shape) == (4, B, S + GEN, 8)
    _assert_tree(got, want, 0.0)
    toks = _tokens()
    jl, jc = j_prefill(jcfg, jp, {"tokens": jnp.asarray(toks[:, :S])},
                       cache_len=S + GEN)
    tl, tc = prefill(tcfg, tp, {"tokens": torch.from_numpy(
        toks[:, :S].astype(np.int64))}, cache_len=S + GEN)
    _assert_rel(tl, jl, 1e-4)
    _assert_tree(tc, jc, 1e-4)
    step = j_serve.decode_step_jit(jcfg)
    for i in range(GEN):
        tok = toks[:, S + i:S + i + 1]
        jl, jc = step(jp, jnp.asarray(tok), jc, jnp.int32(S + i))
        tl, tc = decode_step(tcfg, tp, torch.from_numpy(tok.astype(np.int64)),
                             tc, S + i)
        _assert_rel(tl, jl, 1e-4)
        _assert_tree(tc, jc, 1e-4)


def test_prefill_decode_equal_own_logits_and_generate_matches_reference():
    """The port's prefill and 8 decode steps reproduce its own logits_fn at
    every position they produce, at capacity factor 4.0 (no token drops);
    serve.generate's greedy tokens equal the reference's."""
    _, tcfg, _, tp = _model("float32", 4.0)
    toks = torch.from_numpy(_tokens().astype(np.int64))
    full = logits_fn(tcfg, tp, {"tokens": toks})
    lg, cache = prefill(tcfg, tp, {"tokens": toks[:, :S]}, cache_len=S + GEN)
    _assert_rel(lg[:, 0], full[:, S - 1], 1e-4)
    for i in range(GEN):
        lg, cache = decode_step(tcfg, tp, toks[:, S + i:S + i + 1], cache,
                                S + i)
        _assert_rel(lg[:, 0], full[:, S + i], 1e-4)
    jcfg, tcfg, jp, tp = _model()
    want = j_serve.generate(jcfg, jp, {"tokens": jnp.asarray(
        _tokens()[:, :S])}, S, GEN)
    got = serve.generate(tcfg, tp, {"tokens": toks[:, :S]}, S, GEN)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_converter_round_trips_mla_parameters_and_cache():
    """bf16 deepseek SMOKE parameters (the MLA leaves wq_a, q_norm, wq_b,
    wkv_a, kv_norm, wkv_b, wo, the router, experts and shared expert) and
    the reference's bf16 MLA cache go numpy -> tensors -> numpy bit for
    bit; the port's own init_params has the reference's tree."""
    jcfg, tcfg, jp, _ = _model("bfloat16")
    assert sorted(jp["units"]["b0"]["core"]) == [
        "kv_norm", "q_norm", "wkv_a", "wkv_b", "wo", "wq_a", "wq_b"]
    _, cache = j_prefill(jcfg, jp, {"tokens": jnp.asarray(_tokens()[:, :S])},
                         cache_len=S + GEN)
    assert cache["b0"]["c_kv"].dtype == jnp.bfloat16
    for t in (jp, cache):
        back = to_jax_params(from_jax_params(t))
        assert jax.tree.structure(back) == jax.tree.structure(t)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(t)):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a.view(np.uint8),
                                          np.asarray(b).view(np.uint8))
    mine = to_jax_params(untie_params(tcfg, init_params(
        tcfg, torch.Generator().manual_seed(0))))
    assert jax.tree.structure(mine) == jax.tree.structure(jp)
    for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(jp)):
        assert a.shape == b.shape and a.dtype == b.dtype


def test_fedlora_refuses_an_mla_model():
    """FedLoRA's targets (wq, wv) are not in an MLA attention with
    q_lora_rank > 0: init_lora raises NotImplementedError naming the
    ROADMAP item (the reference returns an empty adapter tree, and its
    FedLoRA then trains nothing)."""
    from repro.optim.lora import init_lora as j_init_lora
    from repro_torch.optim import init_lora
    jcfg, tcfg, jp, tp = _model()
    assert j_init_lora(jcfg, jp, 4, jax.random.PRNGKey(0)) == {"units": {}}
    with pytest.raises(NotImplementedError, match="queue 1, item 6"):
        init_lora(tcfg, tp, 4, prng.PRNGKey(0))
