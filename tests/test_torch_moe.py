"""Port parity: the mixture-of-experts family (``repro_torch.models.moe``,
the MoE blocks of ``models/transformer.py``, and the aux loss through the
MU-SplitFed round, GAS and ``AsyncMuSplitFed``) against the JAX package
on mixtral-8x22b SMOKE (4 layers, d_model 64, 4 experts top-2, window 32),
with the reference's parameters carried across by the converter.

Tolerances (f32). Routing is exact: the expert indices and the kept mask
equal the reference's, and each case first asserts that the k-th and
(k+1)-th routing probabilities of every token are more than 1e-6 apart,
so a routing difference reads as a fault and not as a tie (an exact tie
has its own case: the lower expert index first, as ``jax.lax.top_k``).
The aux loss within 1e-6. Outputs within 1e-5 of their largest magnitude:
the reference's init gives an expert weight the fan-in of its expert count
(scale 1/√E), so an MoE output reaches |y| ~ 130 at SMOKE size and the
f32 sums of the expert products, run in another order, differ by up to
2.3e-5 absolute (1.8e-7 of max|y|). h and the loss likewise; a round's
parameters and metrics within 1e-4. bf16: outputs within 2^-6 of max|y|
(both round the expert products to bf16 in another order), routing exact.
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
from repro.core import baselines as jbase
from repro.core import engine as jengine
from repro.core.splitfed import mu_splitfed_round as j_round
from repro.models import client_forward as j_client
from repro.models import init_params as j_init
from repro.models import server_forward as j_server
from repro.models import split_params as j_split
from repro.models import untie_params as j_untie
from repro.models.moe import apply_moe as j_apply_moe
from repro.models.moe import capacity as j_capacity
from repro.models.moe import init_moe as j_init_moe
from repro_torch.configs import SFLConfig as TSFL
from repro_torch.configs import get_config as t_get_config
from repro_torch.core import baselines as tbase
from repro_torch.core import engine as tengine
from repro_torch.core import prng
from repro_torch.core.splitfed import mu_splitfed_round
from repro_torch.models import client_forward, server_forward, split_params
from repro_torch.models import init_params, untie_params
from repro_torch.models import moe
from repro_torch.models.convert import from_jax_params, to_jax_params
from repro_torch.utils import tree

ARCH = "mixtral-8x22b"
GAP = 1e-6
M = 2


def _cfgs(dtype="float32", **kw):
    j = j_get_config(ARCH, smoke=True).replace(dtype=dtype)
    t = t_get_config(ARCH, smoke=True).replace(dtype=dtype)
    if kw:
        j = j.replace(moe=dataclasses.replace(j.moe, **kw))
        t = t.replace(moe=dataclasses.replace(t.moe, **kw))
    return j, t


@functools.lru_cache(maxsize=None)
def _model(dtype):
    jcfg, tcfg = _cfgs(dtype)
    params = j_untie(jcfg, jax.jit(functools.partial(j_init, jcfg))(
        jax.random.PRNGKey(0)))
    return jcfg, tcfg, params, from_jax_params(params)


def _ffn(dtype):
    """The first layer's MoE parameters, both packages."""
    jp = jax.tree.map(lambda a: a[0], _model(dtype)[2]["units"]["b0"]["ffn"])
    return jp, from_jax_params(jp)


def _x(dtype, B=2, N=64, skew=1.5):
    """(B, N, D) inputs made before any run: a standard normal plus one
    shared direction (``skew`` times a unit-scale vector), which sends
    more tokens to some experts than the capacity takes."""
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((B, N, 64))
         + skew * rng.standard_normal(64)).astype(np.float32)
    jx = jnp.asarray(x, dtype=jnp.dtype(dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    return jx, tx


def _ref_routing(jcfg, jp, jx):
    """The reference's routing and capacity ranks, copied from
    ``repro.models.moe._moe_one_group`` and vmapped over the rows:
    (probs, expert indices (B, N, k), kept (B, N·k))."""
    E, k = jcfg.moe.n_experts, jcfg.moe.top_k

    def one(x):
        N = x.shape[0]
        C = j_capacity(jcfg, N)
        probs = jax.nn.softmax(x.astype(jnp.float32) @ jp["router"], axis=-1)
        _, idx_k = jax.lax.top_k(probs, k)
        e_flat = idx_k.reshape(-1)
        counts = jnp.zeros((E,), jnp.int32).at[e_flat].add(1)
        starts = jnp.cumsum(counts) - counts
        order = jnp.argsort(e_flat, stable=True)
        rank_sorted = (jnp.arange(N * k, dtype=jnp.int32)
                       - starts[e_flat[order]])
        rank = jnp.zeros((N * k,), jnp.int32).at[order].set(rank_sorted)
        return probs, idx_k, rank < C

    return jax.vmap(one)(jx)


def _assert_no_near_ties(probs, k):
    s = np.sort(np.asarray(probs, np.float64), axis=-1)[..., ::-1]
    assert float((s[..., k - 1] - s[..., k]).min()) > GAP


def test_init_moe_matches_reference_layout():
    """init_moe and init_params on mixtral SMOKE: the port's tree, through
    the converter, has the reference's keys, shapes and dtypes (router f32,
    experts (E, D, F) / (E, F, D) in the model type, stacked over the
    units)."""
    jcfg, tcfg = _cfgs("bfloat16")
    gen = torch.Generator().manual_seed(0)
    key = jax.random.PRNGKey(0)
    for want, got in ((jax.eval_shape(lambda: j_init_moe(jcfg, key)),
                       moe.init_moe(tcfg, gen)),
                      (jax.eval_shape(lambda: j_untie(jcfg, j_init(jcfg, key))),
                       untie_params(tcfg, init_params(tcfg, gen)))):
        got = to_jax_params(got)
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            assert a.shape == b.shape and a.dtype == b.dtype
    assert got["units"]["b0"]["ffn"]["router"].dtype == np.float32
    assert sorted(got["units"]["b0"]["ffn"]) == ["router", "wg", "wi", "wo"]


@pytest.mark.parametrize("capacity_factor", [1.25, 8.0])
def test_apply_moe_matches_reference(capacity_factor):
    """apply_moe in f32 at the default capacity (tokens dropped) and at
    8.0 (none dropped): indices and kept mask equal, aux within 1e-6, the
    output within 1e-5 of its largest magnitude."""
    jcfg, tcfg = _cfgs(capacity_factor=capacity_factor)
    jp, tp = _ffn("float32")
    jx, tx = _x("float32")
    probs, idx, kept = _ref_routing(jcfg, jp, jx)
    _assert_no_near_ties(probs, jcfg.moe.top_k)
    _, t_idx, _ = moe.route(tcfg, tp, tx)
    _, t_kept = moe.dispatch_slots(t_idx, tcfg.moe.n_experts,
                                   moe.capacity(tcfg, tx.shape[1]))
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(idx))
    np.testing.assert_array_equal(t_kept.numpy(), np.asarray(kept))
    if capacity_factor == 1.25:
        assert not bool(t_kept.all())          # the case drops tokens
    else:
        assert bool(t_kept.all())
    want, j_aux = j_apply_moe(jcfg, jp, jx)
    got, aux = moe.apply_moe(tcfg, tp, tx)
    want = np.asarray(want)
    assert aux.dtype == torch.float32 and aux.shape == ()
    assert abs(float(aux) - float(j_aux)) <= 1e-6
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


def test_top_k_exact_tie_takes_the_lower_index():
    """Router columns 1 and 2 are zero, so their logits are exactly 0 in
    any summation order, and columns 0 and 3 are minus the inputs' mean
    direction, so their logits are negative for every token: experts 1
    and 2 tie exactly at the top. Both packages put the lower index first
    and agree on the output."""
    jcfg, tcfg = _cfgs()
    jp, _ = _ffn("float32")
    jx, tx = _x("float32")
    x = np.asarray(jx)
    d = x.mean((0, 1))
    assert ((x @ d) > 0).all()
    router = np.zeros((64, 4), np.float32)
    router[:, 0] = router[:, 3] = -d
    jp = dict(jp, router=jnp.asarray(router))
    tp = from_jax_params(jp)
    _, idx, _ = _ref_routing(jcfg, jp, jx)
    _, t_idx, _ = moe.route(tcfg, tp, tx)
    idx = np.asarray(idx)
    assert (idx[..., 0] == 1).all() and (idx[..., 1] == 2).all()
    np.testing.assert_array_equal(t_idx.numpy(), idx)
    want, _ = j_apply_moe(jcfg, jp, jx)
    got, _ = moe.apply_moe(tcfg, tp, tx)
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


def test_apply_moe_bf16_matches_reference():
    """bf16 at bf16 precision: the routing (an f32 product of bf16 inputs)
    exact, the output within 2^-6 of its largest magnitude."""
    jcfg, tcfg = _cfgs("bfloat16")
    jp, tp = _ffn("bfloat16")
    jx, tx = _x("bfloat16")
    probs, idx, _ = _ref_routing(jcfg, jp, jx)
    _assert_no_near_ties(probs, jcfg.moe.top_k)
    _, t_idx, _ = moe.route(tcfg, tp, tx)
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(idx))
    want, j_aux = j_apply_moe(jcfg, jp, jx)
    got, aux = moe.apply_moe(tcfg, tp, tx)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want, np.float32)
    assert np.abs(got.float().numpy() - want).max() <= \
        2.0 ** -6 * np.abs(want).max()
    assert abs(float(aux) - float(j_aux)) <= 1e-6


def _batches(cfg, n=M, S=32, seed=3):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (n, 1, S)).astype(np.int32)
    labels = np.roll(toks, -1, -1)
    j = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    t = {"tokens": torch.from_numpy(toks.astype(np.int64)),
         "labels": torch.from_numpy(labels.astype(np.int64))}
    return j, t


def test_forward_halves_with_aux_match_reference():
    """client_forward's h and aux, and server_forward's loss (which adds
    0.01·aux of both halves), against the reference at the default cut."""
    jcfg, tcfg, jp, tp = _model("float32")
    jb, tb = _batches(tcfg, n=1)
    jb = {k: v[0] for k, v in jb.items()}
    tb = {k: v[0] for k, v in tb.items()}
    cut = tcfg.default_cut_units
    jc, js = j_split(jcfg, jp, cut)
    tc, ts = split_params(tcfg, tp, cut)
    jh, th = j_client(jcfg, jc, jb), client_forward(tcfg, tc, tb)
    want = np.asarray(jh["h"])
    assert np.abs(th["h"].numpy() - want).max() <= 1e-5 * np.abs(want).max()
    assert float(jh["aux"]) > 0.5
    assert abs(float(th["aux"]) - float(jh["aux"])) <= 1e-6
    loss = server_forward(tcfg, ts, th, tb)
    assert abs(float(loss) - float(j_server(jcfg, js, jh, jb))) <= 1e-5


def _maxdiff(t_tree, j_tree):
    got = tree.leaves(to_jax_params(t_tree))
    want = jax.tree.leaves(j_tree)
    assert len(got) == len(want)
    return max(float(np.abs(np.asarray(a, np.float64)
                            - np.asarray(b, np.float64)).max())
               for a, b in zip(got, want))


def test_mu_splitfed_round_matches_reference():
    """One f32 MU-SplitFed round (counter noise, seed replay, M=2 at
    weights 1 and 0.5, τ=2, P=1): parameters and metrics within 1e-4; the
    round-start losses carry 0.01·aux (the clients' aux is above 0.5, so
    a loss without it would be 5e-3 off)."""
    jcfg, tcfg, jp, tp = _model("float32")
    kw = dict(n_clients=M, tau=2, n_perturbations=1, cut_units=2,
              perturbation_dist="counter")
    jb, tb = _batches(tcfg)
    mask = np.array([1.0, 0.5], np.float32)
    want_p, want_m = jax.jit(functools.partial(
        j_round, jcfg, JSFL(**kw), aggregation="seed_replay"))(
        jp, jb, jnp.asarray(mask), jax.random.PRNGKey(5))
    got_p, got_m = mu_splitfed_round(
        tcfg, TSFL(**kw), tp, tb, torch.from_numpy(mask), prng.PRNGKey(5),
        aggregation="seed_replay")
    assert _maxdiff(got_p, want_p) <= 1e-4
    for f in want_m._fields:
        np.testing.assert_allclose(getattr(got_m, f).numpy(),
                                   np.asarray(getattr(want_m, f)),
                                   atol=1e-4)


def test_gas_round_buffers_the_reference_aux():
    """GAS with a stale client (fresh 1, 0): the buffered aux is nonzero
    and equal to the reference's within 1e-6, the buffered h within 1e-5
    of its largest magnitude, the parameters and the losses within 1e-4."""
    jcfg, tcfg, jp, tp = _model("float32")
    kw = dict(n_clients=M, tau=2, n_perturbations=1, cut_units=2,
              perturbation_dist="counter")
    jb0, tb0 = _batches(tcfg, seed=3)
    jb1, tb1 = _batches(tcfg, seed=4)
    fresh = np.array([1.0, 0.0], np.float32)
    jsfl, tsfl = JSFL(**kw), TSFL(**kw)
    jstate = jbase.gas_init_state(jcfg, jsfl, jp, jb0)
    want_p, want_s, want_m = jax.jit(functools.partial(
        jbase.gas_round, jcfg, jsfl))(jp, jstate, jb1, jnp.asarray(fresh),
                                      jax.random.PRNGKey(6))
    tstate = tbase.gas_init_state(tcfg, tsfl, tp, tb0)
    got_p, got_s, got_m = tbase.gas_round(
        tcfg, tsfl, tp, tstate, tb1, torch.from_numpy(fresh),
        prng.PRNGKey(6))
    want_aux = np.asarray(want_s.h_buffer["aux"])
    assert (want_aux > 0.5).all()
    np.testing.assert_allclose(got_s.h_buffer["aux"].numpy(), want_aux,
                               atol=1e-6)
    want_h = np.asarray(want_s.h_buffer["h"])
    assert np.abs(got_s.h_buffer["h"].numpy() - want_h).max() <= \
        1e-5 * np.abs(want_h).max()
    assert _maxdiff(got_p, want_p) <= 1e-4
    np.testing.assert_allclose(got_m.loss.numpy(), np.asarray(want_m.loss),
                               atol=1e-4)


def test_async_mu_splitfed_losses_carry_the_reference_aux():
    """One semi-async version through ``AsyncMuSplitFed`` (the engine's
    'async_mu_splitfed': its store from init_state, its async_round_fn;
    both clients start, apply weights 0.75 and 0.25): the store's
    fetch-time losses, which include 0.01·aux, within 1e-5 of the
    reference's, its keys exact, its coefficients and the parameters
    within 1e-4; the clients' aux is nonzero."""
    jcfg, tcfg, jp, tp = _model("float32")
    kw = dict(n_clients=M, tau=2, n_perturbations=1, cut_units=2,
              perturbation_dist="counter", quorum=1)
    jb, tb = _batches(tcfg)
    jsfl, tsfl = JSFL(**kw), TSFL(**kw)
    start = np.ones(M, np.float32)
    apply_w = np.array([0.75, 0.25], np.float32)
    jalgo = jengine.get_algorithm("async_mu_splitfed")
    talgo = tengine.get_algorithm("async_mu_splitfed")
    want_p, want_s, _ = jax.jit(functools.partial(
        jalgo.async_round_fn, jcfg, jsfl))(
        jp, jalgo.init_state(jcfg, jsfl, jp, None), jb, jnp.asarray(start),
        jnp.asarray(apply_w), jax.random.PRNGKey(8))
    got_p, got_s, _ = talgo.async_round_fn(
        tcfg, tsfl, tp, talgo.init_state(tcfg, tsfl, tp, None), tb, start,
        torch.from_numpy(apply_w), prng.PRNGKey(8))
    xc = j_split(jcfg, jp, 2)[0]
    auxes = [float(j_client(jcfg, xc, {k: v[m] for k, v in jb.items()})
                   ["aux"]) for m in range(M)]
    assert min(auxes) > 0.5
    np.testing.assert_allclose(got_s["loss0"].numpy(),
                               np.asarray(want_s["loss0"]), atol=1e-5)
    for k in ("srv_keys", "ukey"):
        np.testing.assert_array_equal(got_s[k], np.asarray(want_s[k]))
    for k in ("srv_coeffs", "ccoeff"):
        np.testing.assert_allclose(got_s[k].numpy(), np.asarray(want_s[k]),
                                   atol=1e-4)
    assert _maxdiff(got_p, want_p) <= 1e-4


def _port_config(arch):
    """The reference's SMOKE config of ``arch``, built field for field as
    the port's ModelConfig."""
    from repro_torch.configs import ModelConfig, MoEConfig
    j = j_get_config(arch, smoke=True)
    kw = dict(j.__dict__)
    if j.moe is not None:
        kw["moe"] = MoEConfig(**j.moe.__dict__)
    return ModelConfig(**kw)


@pytest.mark.parametrize("arch", ["llama-3.2-vision-90b", "whisper-tiny"])
def test_unported_families_raise_naming_the_queue(arch):
    """The families not ported yet (the VLM's cross-attention, the
    encoder-decoder), built field for field from the
    reference's SMOKE configs, raise NotImplementedError naming ROADMAP
    queue 1 item 6 at init_params and init_cache."""
    from repro_torch.models import init_cache
    cfg = _port_config(arch)
    with pytest.raises(NotImplementedError, match="queue 1, item 6"):
        init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="queue 1, item 6"):
        init_cache(cfg, 1, 8, device="cpu")


def test_gqa_functions_refuse_an_mla_config():
    """deepseek-v2-236b's MLA config has no GQA projections: the GQA
    functions (gqa_attention, gqa_decode) still raise NotImplementedError
    naming ROADMAP queue 1 item 6 on it."""
    from repro_torch.models import attention
    cfg = _port_config("deepseek-v2-236b")
    assert cfg.attn_impl == "mla"
    with pytest.raises(NotImplementedError, match="queue 1, item 6"):
        attention.gqa_attention(cfg, {}, torch.zeros(1, 4, 64),
                                torch.zeros(1, 4, dtype=torch.int64))
    with pytest.raises(NotImplementedError, match="queue 1, item 6"):
        attention.gqa_decode(cfg, {}, torch.zeros(1, 1, 64), {}, 0)


def test_converter_round_trips_moe_and_cache_trees():
    """bf16 mixtral SMOKE parameters and a bf16 decode cache (the
    reference's prefill's) go numpy -> tensors -> numpy bit for bit, with
    their structure: the converter needs no change for either."""
    from repro.models import prefill as j_prefill
    jcfg, _, jp, _ = _model("bfloat16")
    toks = np.random.default_rng(0).integers(0, 256, (2, 40), np.int32)
    _, cache = j_prefill(jcfg, jp, {"tokens": jnp.asarray(toks)},
                         cache_len=44)
    for t in (jp, cache):
        back = to_jax_params(from_jax_params(t))
        assert jax.tree.structure(back) == jax.tree.structure(t)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(t)):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a.view(np.uint8),
                                          np.asarray(b).view(np.uint8))
    assert cache["b0"]["k"].dtype == jnp.bfloat16
