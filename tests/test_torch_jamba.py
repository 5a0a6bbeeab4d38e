"""Port parity: the Mamba hybrid (``repro_torch.models.ssm``, the
selective scan's plain version ``kernels/ref.py:selective_scan_ref``, the
mixed block patterns of ``models/transformer.py``) against the JAX
package on jamba-1.5-large-398b SMOKE (16 layers in 2 units of the
pattern mamba ×3, attn, mamba ×4; d_model 64, d_inner 128, d_state 4,
dt_rank 4, 4 experts top-2 at pattern positions 1, 3, 5, 7), with the
reference's parameters carried across by the converter.

Tolerances (f32 unless named). The scan: the port runs the recurrence one
token at a time, the reference as an associative scan inside chunks of
16 tokens (products of the decays in another order), so y within 1e-5
of max|y| and h within 1e-5 of max|h|. ``mamba_forward``'s y, h and conv
state likewise; in bf16 y within 2^-5 of max|y| and h within 2^-5 of
max|h| (the bf16 in_proj and x_proj products round their sums in
another order, a bf16 ulp of the activations, carried through the scan).
The model's forward halves, loss, logits, one MU-SplitFed round (counter
noise, seed replay), prefill, decode steps and their caches within 1e-4
of max(the quantity's largest magnitude, 1). The port's own prefill and
decode against its own logits_fn within 1e-4 of that scale, at a capacity
where no token drops. Greedy tokens equal. The converter keeps every bit.
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
                                init_params, logits_fn, loss_fn, moe,
                                prefill, server_forward, split_dims,
                                split_params, ssm, untie_params)
from repro_torch.models.convert import from_jax_params, to_jax_params
from repro_torch.utils import tree

ARCH = "jamba-1.5-large-398b"
B, S, GEN = 2, 16, 8
MOE_POSITIONS = (1, 3, 5, 7)


@functools.lru_cache(maxsize=None)
def _params(dtype):
    jcfg = j_get_config(ARCH, smoke=True).replace(dtype=dtype)
    params = j_untie(jcfg, jax.jit(functools.partial(j_init, jcfg))(
        jax.random.PRNGKey(0)))
    return params, from_jax_params(params)


def _model(dtype="float32", capacity_factor=None):
    """(reference config, port config, reference params, port params); the
    parameters are made once a dtype (the capacity factor changes none)."""
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
    """Pattern block j's Mamba (or attention) parameters of one unit."""
    return jax.tree.map(lambda a: a[unit], params["units"][f"b{j}"]["core"])


def _t_core(params, j, unit=0):
    return tree.tree_map(lambda a: a[unit], params["units"][f"b{j}"]["core"])


def _x(dtype, n, seed=7, width=64):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, n, width)).astype(np.float32)
    return (jnp.asarray(x, dtype=jnp.dtype(dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def _h0(jcfg, seed=11, scale=0.5):
    d_in, N, _, _, _ = j_ssm.mamba_dims(jcfg)
    return (np.random.default_rng(seed).standard_normal((B, d_in, N))
            * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# the selective scan and the Mamba block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,h0_scale", [(16, 0.0), (16, 0.5), (1, 0.5)],
                         ids=["zero_h0", "h0", "one_token"])
def test_selective_scan_ref_matches_the_reference_chain(n, h0_scale):
    """selective_scan_ref on the post-conv activation of the first Mamba
    block against the reference's _mamba_ssm_params -> _ssm_scan_chunk ->
    C contraction -> D and silu(z) gate (one chunk of n tokens), with zero
    and nonzero h0 and at one token: y and h_last within 1e-5 of their
    largest magnitude."""
    jcfg, tcfg, jp, tp = _model()
    d_in, N, _, dt_rank, _ = j_ssm.mamba_dims(jcfg)
    rng = np.random.default_rng(5)
    xs = (rng.standard_normal((B, n, d_in)) * 2.0).astype(np.float32)
    z = rng.standard_normal((B, n, d_in)).astype(np.float32)
    h0 = _h0(jcfg, scale=h0_scale)
    jc = _core(jp, 0)
    dA, dBx, Cc = j_ssm._mamba_ssm_params(jcfg, jc, jnp.asarray(xs))
    h_all, h_last = j_ssm._ssm_scan_chunk(dA.swapaxes(0, 1),
                                          dBx.swapaxes(0, 1), jnp.asarray(h0))
    y = jnp.einsum("lbdn,bln->bld", h_all, Cc)
    want = (y + xs * jc["D"]) * jax.nn.silu(jnp.asarray(z))
    tc = _t_core(tp, 0)
    x_dbl = torch.from_numpy(xs) @ tc["x_proj"]
    dt = x_dbl[..., :dt_rank] @ tc["dt_proj"]
    got, got_h = ref.selective_scan_ref(
        torch.from_numpy(xs), dt, torch.from_numpy(z),
        x_dbl[..., dt_rank:dt_rank + N], x_dbl[..., dt_rank + N:],
        tc["A_log"], tc["D"], tc["dt_bias"], torch.from_numpy(h0))
    assert got.dtype == torch.float32 and tuple(got_h.shape) == (B, d_in, N)
    _assert_rel(got, want, 1e-5, floor=0.0)
    _assert_rel(got_h, h_last, 1e-5, floor=0.0)


def test_selective_scan_writes_h_out_in_place_on_the_cpu():
    """The wrapper on CPU tensors runs the plain version; h_out (h0
    itself, as decode passes it) receives h_last, equal to a call that
    returns a new h."""
    rng = np.random.default_rng(2)
    d_in, N, n = 8, 4, 5
    x, z, dt = (torch.from_numpy(rng.standard_normal((1, n, d_in)).astype(
        np.float32)) for _ in range(3))
    Bc, Cc = (torch.from_numpy(rng.standard_normal((1, n, N)).astype(
        np.float32)) for _ in range(2))
    A_log = torch.log(torch.arange(1, N + 1.0).expand(d_in, N).contiguous())
    D, bias = torch.ones(d_in), torch.full((d_in,), -4.6)
    h0 = torch.from_numpy(rng.standard_normal((1, d_in, N)).astype(
        np.float32))
    y, h = ops.selective_scan_op(x, dt, z, Bc, Cc, A_log, D, bias, h0)
    state = h0.clone()
    y2, h2 = ops.selective_scan_op(x, dt, z, Bc, Cc, A_log, D, bias, state,
                                   h_out=state)
    assert h2 is state and torch.equal(y2, y) and torch.equal(state, h)
    assert not torch.equal(h, h0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_forward_matches_reference(dtype):
    """The first Mamba block's mamba_forward at S = 40 (two 16-token chunks
    of the reference and its 8-token tail, ``ssm.py:119-121``) from a
    nonzero h: y, h and the conv state. f32 within 1e-5 of each largest
    magnitude; bf16 within 2^-5."""
    jcfg, tcfg, jp, tp = _model(dtype)
    jx, tx = _x(dtype, 40)
    h0 = _h0(jcfg)
    jstate = j_ssm.mamba_init_state(jcfg, B)
    jstate["h"] = jnp.asarray(h0)
    tstate = ssm.mamba_init_state(tcfg, B)
    tstate["h"] = torch.from_numpy(h0)
    want, wstate = _jit(j_ssm.mamba_forward, jcfg)(_core(jp, 0), jx, jstate)
    got, gstate = ssm.mamba_forward(tcfg, _t_core(tp, 0), tx, tstate)
    assert got.dtype == tx.dtype and gstate["conv"].dtype == tx.dtype
    assert gstate["h"].dtype == torch.float32
    tol = 1e-5 if dtype == "float32" else 2.0 ** -5
    _assert_rel(got, want, tol, floor=0.0)
    _assert_rel(gstate["h"], wstate["h"], tol, floor=0.0)
    _assert_rel(gstate["conv"], wstate["conv"], tol, floor=0.0)


def test_mamba_decode_matches_reference_for_four_steps():
    """mamba_decode for 4 tokens from mamba_forward's state after a
    12-token prompt (the reference's ``mamba_decode`` step by step): each
    step's y and the carried h and conv within 1e-5; the port's state
    tensors are updated in place."""
    jcfg, tcfg, jp, tp = _model()
    jx, tx = _x("float32", 16)
    jc, tc = _core(jp, 0), _t_core(tp, 0)
    _, jstate = _jit(j_ssm.mamba_forward, jcfg)(jc, jx[:, :12])
    _, tstate = ssm.mamba_forward(tcfg, tc, tx[:, :12])
    h, conv = tstate["h"], tstate["conv"]
    step = _jit(j_ssm.mamba_decode, jcfg)
    for i in range(12, 16):
        want, jstate = step(jc, jx[:, i:i + 1], jstate)
        got, tstate = ssm.mamba_decode(tcfg, tc, tx[:, i:i + 1], tstate)
        assert tstate["h"] is h and tstate["conv"] is conv
        _assert_rel(got, want, 1e-5, floor=0.0)
        _assert_rel(tstate["h"], jstate["h"], 1e-5, floor=0.0)
        _assert_rel(tstate["conv"], jstate["conv"], 1e-5, floor=0.0)


# ---------------------------------------------------------------------------
# the mixed-pattern model
# ---------------------------------------------------------------------------

def test_init_params_and_split_dims_match_reference():
    """The port's init_params has the reference's tree: keys b0..b7, leaf
    order (the noise salt is the leaf index: A_log, D, conv_b, ... sort
    first), shapes and dtypes (A_log, D and dt_bias f32 in a bf16 model),
    MoE at pattern positions 1, 3, 5, 7; split_dims equal at both cuts of
    SMOKE and at the published config's default cut."""
    jcfg = j_get_config(ARCH, smoke=True)
    tcfg = t_get_config(ARCH, smoke=True)
    shapes = jax.eval_shape(lambda: j_untie(jcfg, j_init(
        jcfg, jax.random.PRNGKey(0))))
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
    assert sorted(units) == [f"b{j}" for j in range(8)]
    for j in range(8):
        assert ("router" in units[f"b{j}"]["ffn"]) == (j in MOE_POSITIONS)
        assert ("A_log" in units[f"b{j}"]["core"]) == (j != 3)
    assert units["b0"]["core"]["A_log"].dtype == torch.float32
    assert sorted(units["b0"]["core"])[:3] == ["A_log", "D", "conv_b"]
    for cut in (1, 2):
        assert split_dims(tcfg, cut) == j_split_dims(jcfg, cut)
    full_j, full_t = j_get_config(ARCH), t_get_config(ARCH)
    assert split_dims(full_t, 1) == j_split_dims(full_j, 1)


def _batches(n=2, seed=3, seq=S):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 256, (n, 1, seq)).astype(np.int32)
    labels = np.roll(toks, -1, -1)
    j = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    t = {"tokens": torch.from_numpy(toks.astype(np.int64)),
         "labels": torch.from_numpy(labels.astype(np.int64))}
    return j, t


def test_forward_halves_loss_and_logits_match_reference():
    """client_forward's h and aux, server_forward's loss, loss_fn and
    logits_fn against the reference at the default cut (1 of 2 units),
    within 1e-4 of max(|·|, 1)."""
    jcfg, tcfg, jp, tp = _model()
    jb, tb = _batches(n=1)
    jb = {k: v[0] for k, v in jb.items()}
    tb = {k: v[0] for k, v in tb.items()}
    jc, js = j_split(jcfg, jp, 1)
    tc, ts = split_params(tcfg, tp, 1)
    jh, th = _jit(j_client, jcfg)(jc, jb), client_forward(tcfg, tc, tb)
    _assert_rel(th["h"], jh["h"], 1e-4)
    assert float(jh["aux"]) > 0.5
    _assert_rel(th["aux"], jh["aux"], 1e-4)
    want = _jit(j_server, jcfg)(js, jh, jb)
    _assert_rel(server_forward(tcfg, ts, th, tb), want, 1e-4)
    _assert_rel(loss_fn(tcfg, tp, tb), want, 1e-4)
    _assert_rel(logits_fn(tcfg, tp, tb), _jit(j_logits, jcfg)(jp, jb), 1e-4)


def test_mu_splitfed_round_matches_reference(monkeypatch):
    """One MU-SplitFed round (counter noise, seed replay, M=2 at weights 1
    and 0.5, τ=2, P=1, cut after the first unit) over every Mamba,
    attention, norm, router and expert leaf: parameters and metrics within
    1e-4. The round first asserts that in every routing of its forwards
    (perturbed ones included) the top-2 and third routing probabilities of
    each token are more than 1e-6 apart, as tests/test_torch_moe.py's
    cases do: a token closer to a tie than that can go to another expert
    on either side of an f32 rounding, and a client delta is a loss
    difference over 2λ (at the round key 5 a gap of 3e-8 moved client 0's
    delta from -0.031 to -0.176)."""
    jcfg, tcfg, jp, tp = _model()
    kw = dict(n_clients=2, tau=2, n_perturbations=1, cut_units=1,
              perturbation_dist="counter")
    jb, tb = _batches()
    mask = np.array([1.0, 0.5], np.float32)
    gaps = []
    route = moe.route

    def gap_route(cfg, p, x):
        probs = torch.softmax(x.to(torch.float32) @ p["router"], -1)
        top = probs.sort(-1, descending=True).values
        gaps.append(float((top[..., 1] - top[..., 2]).min()))
        return route(cfg, p, x)

    monkeypatch.setattr(moe, "route", gap_route)
    got_p, got_m = mu_splitfed_round(
        tcfg, TSFL(**kw), tp, tb, torch.from_numpy(mask), prng.PRNGKey(6),
        aggregation="seed_replay")
    assert len(gaps) == 80 and min(gaps) > 1e-6
    want_p, want_m = jax.jit(functools.partial(
        j_round, jcfg, JSFL(**kw), aggregation="seed_replay"))(
        jp, jb, jnp.asarray(mask), jax.random.PRNGKey(6))
    _assert_tree(got_p, want_p, 1e-4)
    for f in want_m._fields:
        _assert_rel(getattr(got_m, f), getattr(want_m, f), 1e-4)


def test_init_cache_prefill_and_decode_match_reference():
    """init_cache's layout (a Mamba position {"h" (2, B, 128, 4) f32,
    "conv" (2, B, 3, 128)}, the attention position {"k", "v"}; zeros)
    equals the reference's; prefill's last logits and cache, then 8
    decode steps' logits and caches (the reference's decode_step_jit),
    within 1e-4."""
    jcfg, tcfg, jp, tp = _model()
    want = j_init_cache(jcfg, B, S + GEN)
    got = init_cache(tcfg, B, S + GEN, device="cpu")
    assert tuple(got["b0"]["h"].shape) == (2, B, 128, 4)
    assert got["b0"]["h"].dtype == torch.float32
    assert tuple(got["b0"]["conv"].shape) == (2, B, 3, 128)
    assert sorted(got["b3"]) == ["k", "v"]
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
    every position they produce, at capacity factor 2.0 (n_experts/top_k:
    no token drops); serve.generate's greedy tokens equal the
    reference's."""
    _, tcfg, _, tp = _model("float32", 2.0)
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


def test_short_prompt_keeps_the_initial_conv_state_as_the_reference():
    """A 2-token prompt (S < d_conv - 1 = 3): the reference's prefill keeps
    the zero conv state (``ssm.py:124-125``), so its decode of the third
    token misses the prompt in the conv (ROADMAP.md, queue 3, reference
    side). The port follows it: prefill's cache and logits and the decode
    step within 1e-4 of the reference's, and the conv state zero; the
    decode step is then off the full forward on the three tokens by more
    than 1e-3 of its largest logit, where it would be within 1e-4 had the
    prompt been kept."""
    jcfg, tcfg, jp, tp = _model("float32", 2.0)
    toks = _tokens()[:, :3]
    jl, jc = j_prefill(jcfg, jp, {"tokens": jnp.asarray(toks[:, :2])},
                       cache_len=3)
    tl, tc = prefill(tcfg, tp, {"tokens": torch.from_numpy(
        toks[:, :2].astype(np.int64))}, cache_len=3)
    _assert_rel(tl, jl, 1e-4)
    _assert_tree(tc, jc, 1e-4)
    assert not tc["b0"]["conv"].any()
    jl, _ = j_serve.decode_step_jit(jcfg)(jp, jnp.asarray(toks[:, 2:3]), jc,
                                          jnp.int32(2))
    tl, _ = decode_step(tcfg, tp, torch.from_numpy(
        toks[:, 2:3].astype(np.int64)), tc, 2)
    _assert_rel(tl, jl, 1e-4)
    full = logits_fn(tcfg, tp, {"tokens": torch.from_numpy(
        toks.astype(np.int64))})[:, 2]
    scale = float(full.abs().max())
    assert _err(tl[:, 0], full) > 1e-3 * scale


def test_driver_and_serve_main_run_jamba_on_the_cpu(capsys):
    """``launch.train --arch jamba-1.5-large-398b --smoke --device cpu
    --rounds 2`` (M=2, seq 16): finite losses and moved parameters;
    ``launch.serve`` on the same arch generates (B, gen) tokens."""
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
                       "--batch", "2", "--prompt-len", "12", "--gen", "3"])
    assert tuple(toks.shape) == (2, 3)
    assert "generated (2, 3)" in capsys.readouterr().out


def test_converter_round_trips_jamba_parameters_and_cache():
    """bf16 jamba SMOKE parameters (the Mamba leaves with their f32 A_log,
    D and dt_bias) and the reference's bf16 prefill cache (f32 h, bf16
    conv) go numpy -> tensors -> numpy bit for bit, with their dtypes."""
    jcfg, _, jp, tp = _model("bfloat16")
    core = tp["units"]["b0"]["core"]
    assert {n: str(core[n].dtype) for n in ("A_log", "D", "dt_bias",
                                            "in_proj")} == {
        "A_log": "torch.float32", "D": "torch.float32",
        "dt_bias": "torch.float32", "in_proj": "torch.bfloat16"}
    _, cache = j_prefill(jcfg, jp, {"tokens": jnp.asarray(_tokens()[:, :S])},
                         cache_len=S + GEN)
    assert cache["b0"]["h"].dtype == jnp.float32
    assert cache["b0"]["conv"].dtype == jnp.bfloat16
    for t in (jp, cache):
        back = to_jax_params(from_jax_params(t))
        assert jax.tree.structure(back) == jax.tree.structure(t)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(t)):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a.view(np.uint8),
                                          np.asarray(b).view(np.uint8))


def test_card_smoke_config_widens_jamba():
    """configs.card_smoke_config('jamba-1.5-large-398b'): d_model 128,
    d_inner 256, 2 query heads of 64 (the flash kernel's head dim), d_state
    4 (a kernel instance) and SMOKE's 4 experts top-2, in f32."""
    cfg = card_smoke_config(ARCH)
    d_in, N, d_conv, dt_rank, _ = ssm.mamba_dims(cfg)
    assert (cfg.d_model, d_in, N, d_conv, dt_rank) == (128, 256, 4, 4, 8)
    assert (cfg.n_heads, cfg.d_head, cfg.n_kv_heads) == (2, 64, 1)
    assert (cfg.moe.n_experts, cfg.moe.top_k, cfg.dtype) == (4, 2, "float32")
    assert cfg.block_pattern == t_get_config(ARCH).block_pattern
