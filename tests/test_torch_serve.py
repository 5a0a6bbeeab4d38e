"""Port parity: serving (``init_cache``, ``prefill``, ``decode_step`` and
``launch/serve.py``) against the JAX package on the CPU, for the SMOKE
configs of the five dense archs and mixtral-8x22b, with the reference's
parameters carried across by the converter.

The reference's ``decode_step`` runs through its own per-config jit
(``repro.launch.serve.decode_step_jit``), so each arch compiles it once
for the whole file (prompts of 16, caches of 20).

Tolerances. Cache layouts (keys, shapes, dtypes) exact. f32: prefill's
logits and cache, and each decode step's logits and cache, within 1e-5 of
max(their largest magnitude, 1) (mixtral's MoE outputs reach ~10^2 at
SMOKE size, see tests/test_torch_moe.py; the dense archs' logits stay
below 1, where this is 1e-5 absolute). bf16: within 2^-5 of that scale (the port's prefill keeps the flash
kernel's f32 probabilities where the reference casts them to bf16,
tests/test_torch_models.py). The port's own prefill + decode against its
own full-sequence logits within 1e-4 of that scale. Greedy
and temperature tokens equal to the reference's (the gumbel draws are the
reference's bits; the logs within 2 f32 ulps of max(|g|, 1)).
"""
import dataclasses
import functools
import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from one_torch_thread import one_torch_thread  # noqa: F401
from repro.configs import get_config as j_get_config
from repro.launch import serve as j_serve
from repro.models import init_cache as j_init_cache
from repro.models import init_params as j_init
from repro.models import prefill as j_prefill
from repro_torch import obs
from repro_torch.configs import get_config as t_get_config
from repro_torch.core import prng
from repro_torch.launch import serve
from repro_torch.models import decode_step, init_cache, logits_fn, prefill
from repro_torch.models.convert import from_jax_params, to_jax_params

ARCHS = ["olmo-1b", "paper-opt-1.3b", "qwen3-14b", "internlm2-1.8b",
         "mistral-nemo-12b", "mixtral-8x22b"]
B, S, GEN = 2, 16, 4
F32_TOL, BF16_TOL = 1e-5, 2.0 ** -5


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    return request.param


@functools.lru_cache(maxsize=None)
def _setup(arch, dtype="float32", **cfg_kw):
    jcfg = j_get_config(arch, smoke=True).replace(dtype=dtype, **cfg_kw)
    tcfg = t_get_config(arch, smoke=True).replace(dtype=dtype, **cfg_kw)
    params = j_init(jcfg, jax.random.PRNGKey(0))
    toks = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (B, S + GEN)).astype(np.int32)
    return jcfg, tcfg, params, from_jax_params(params), toks


def _tokens(toks, n):
    return ({"tokens": jnp.asarray(toks[:, :n])},
            {"tokens": torch.from_numpy(toks[:, :n].astype(np.int64))})


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _assert_rel(got, want, tol):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1.0)


def _assert_cache(got, want, tol):
    got = to_jax_params(got)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.dtype == b.dtype
        _assert_rel(a, b, tol)


def test_init_cache_matches_reference(arch):
    """init_cache's keys, shapes and dtypes equal the reference's (bf16
    SMOKE), with and without a ring (mixtral's window 32)."""
    jcfg = j_get_config(arch, smoke=True)
    tcfg = t_get_config(arch, smoke=True)
    for seq_len in (20, 40):
        want = j_init_cache(jcfg, B, seq_len)
        got = to_jax_params(init_cache(tcfg, B, seq_len, device="cpu"))
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            assert a.shape == b.shape and a.dtype == b.dtype
            assert not np.asarray(a).any()


def test_prefill_and_decode_match_reference(arch):
    """f32: prefill's last logits and cache, then GEN decode steps' logits
    and caches, each against the reference's (its decode_step_jit)."""
    jcfg, tcfg, jp, tp, toks = _setup(arch)
    jb, tb = _tokens(toks, S)
    jl, jc = j_prefill(jcfg, jp, jb, cache_len=S + GEN)
    tl, tc = prefill(tcfg, tp, tb, cache_len=S + GEN)
    _assert_rel(tl, jl, F32_TOL)
    _assert_cache(tc, jc, F32_TOL)
    step = j_serve.decode_step_jit(jcfg)
    for i in range(GEN):
        tok = toks[:, S + i:S + i + 1]
        jl, jc = step(jp, jnp.asarray(tok), jc, jnp.int32(S + i))
        tl, tc = decode_step(tcfg, tp, torch.from_numpy(tok.astype(np.int64)),
                             tc, S + i)
        _assert_rel(tl, jl, F32_TOL)
        _assert_cache(tc, jc, F32_TOL)


@pytest.mark.parametrize("arch_bf16", ["qwen3-14b", "mixtral-8x22b"])
def test_prefill_bf16_matches_reference(arch_bf16):
    """bf16 at bf16 precision: prefill's logits and cache."""
    jcfg, tcfg, jp, tp, toks = _setup(arch_bf16, "bfloat16")
    jb, tb = _tokens(toks, S)
    jl, jc = j_prefill(jcfg, jp, jb, cache_len=S + GEN)
    tl, tc = prefill(tcfg, tp, tb, cache_len=S + GEN)
    assert tl.dtype == torch.bfloat16
    _assert_rel(tl, jl, BF16_TOL)
    _assert_cache(tc, jc, BF16_TOL)


def test_decode_past_the_window_matches_reference_step_by_step():
    """mixtral with sliding_window=8 (tests/test_models.py's ring case): a
    12-token prompt fills the 8-slot ring, and 4 decode steps wrap it; at
    every step the logits and the ring equal the reference's."""
    jcfg, tcfg, jp, tp, toks = _setup("mixtral-8x22b", sliding_window=8)
    jb, tb = _tokens(toks, 12)
    jl, jc = j_prefill(jcfg, jp, jb, cache_len=16)
    tl, tc = prefill(tcfg, tp, tb, cache_len=16)
    assert tuple(tc["b0"]["k"].shape) == (4, B, 2, 8, 16)
    _assert_rel(tl, jl, F32_TOL)
    _assert_cache(tc, jc, F32_TOL)
    step = j_serve.decode_step_jit(jcfg)
    for i in range(4):
        tok = toks[:, 12 + i:13 + i]
        jl, jc = step(jp, jnp.asarray(tok), jc, jnp.int32(12 + i))
        tl, tc = decode_step(tcfg, tp, torch.from_numpy(tok.astype(np.int64)),
                             tc, 12 + i)
        _assert_rel(tl, jl, F32_TOL)
        _assert_cache(tc, jc, F32_TOL)


def test_prefill_decode_equals_own_full_logits(arch):
    """The port's prefill then decode reproduce its own logits_fn at every
    position they produce (tests/test_models.py's check, held within 1e-4
    of the largest logit); MoE at a capacity where no token drops."""
    _, tcfg, _, tp, toks = _setup(arch)
    if tcfg.moe is not None:
        tcfg = tcfg.replace(moe=dataclasses.replace(tcfg.moe,
                                                    capacity_factor=16.0))
    full = logits_fn(tcfg, tp, {"tokens": torch.from_numpy(
        toks.astype(np.int64))})
    _, tb = _tokens(toks, S)
    lg, cache = prefill(tcfg, tp, tb, cache_len=S + GEN)
    _assert_rel(lg[:, 0], full[:, S - 1], 1e-4)
    for i in range(GEN):
        tok = torch.from_numpy(toks[:, S + i:S + i + 1].astype(np.int64))
        lg, cache = decode_step(tcfg, tp, tok, cache, S + i)
        _assert_rel(lg[:, 0], full[:, S + i], 1e-4)


def test_generate_matches_reference(arch):
    """serve.generate, greedy and at temperature 0.7 from key 11: the
    reference's tokens."""
    jcfg, tcfg, jp, tp, toks = _setup(arch)
    jb, tb = _tokens(toks, S)
    for temp in (0.0, 0.7):
        want = j_serve.generate(jcfg, jp, jb, S, GEN, temperature=temp,
                                key=jax.random.PRNGKey(11))
        got = serve.generate(tcfg, tp, tb, S, GEN, temperature=temp,
                             key=prng.PRNGKey(11))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_gumbel_draws_match_reference():
    """core/prng.py's uniform bits equal jax.random.uniform's exactly (f32
    and bf16), and its gumbel is within 2 f32 ulps of max(|g|, 1) of
    jax.random.gumbel's (the two logs are other f32 approximations; exact
    in bf16)."""
    key = jax.random.split(jax.random.PRNGKey(2))[1]
    nkey = prng.split(prng.PRNGKey(2))[1]
    np.testing.assert_array_equal(np.asarray(jax.random.key_data(key)), nkey)
    for dtype, jdt in (("float32", jnp.float32), ("bfloat16", jnp.bfloat16)):
        u = np.asarray(jax.random.uniform(key, (3, 1000), jdt), np.float32)
        np.testing.assert_array_equal(prng.uniform(nkey, (3, 1000), dtype), u)
        g = np.asarray(jax.random.gumbel(key, (3, 1000), jdt), np.float32)
        got = prng.gumbel(nkey, (3, 1000), dtype)
        ulps = 0 if dtype == "bfloat16" else 2
        assert (np.abs(got - g)
                <= ulps * np.spacing(np.maximum(np.abs(g), 1))).all()


def test_stats_after_a_call_and_the_http_endpoint():
    """One generate call moves serve.requests by 1 and serve.tokens by
    B·GEN and observes one serve.generate_seconds; GET /stats on
    serve_stats(0)'s port returns the same counters."""
    _, tcfg, _, tp, toks = _setup("olmo-1b")
    reg = obs.get_registry()
    before = reg.snapshot()

    def count(snap, name, field="value"):
        return snap.get(name, {}).get(field, 0)

    serve.generate(tcfg, tp, _tokens(toks, S)[1], S, GEN)
    snap = serve.stats()
    assert snap["uptime_s"] >= 0
    m = snap["metrics"]
    assert count(m, "serve.requests") == count(before, "serve.requests") + 1
    assert count(m, "serve.tokens") == \
        count(before, "serve.tokens") + B * GEN
    assert count(m, "serve.generate_seconds", "count") == \
        count(before, "serve.generate_seconds", "count") + 1
    assert m["serve.last_tok_per_s"]["value"] > 0
    srv = serve.serve_stats(0)
    try:
        port = srv.server_address[1]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats",
                                    timeout=10) as r:
            body = json.loads(r.read())
        assert body["metrics"]["serve.requests"] == m["serve.requests"]
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"http://127.0.0.1:{port}/nope",
                                   timeout=10)
    finally:
        srv.shutdown()
        srv.server_close()


def test_serve_main_runs_on_the_cpu(capsys):
    """serve.main with --device cpu: generates (B, gen) tokens of the
    mixtral SMOKE model past its window and prints the stats."""
    toks = serve.main(["--arch", "mixtral-8x22b", "--smoke", "--device",
                       "cpu", "--batch", "2", "--prompt-len", "40", "--gen",
                       "3", "--stats"])
    assert tuple(toks.shape) == (2, 3)
    out = capsys.readouterr().out
    assert "generated (2, 3)" in out and '"serve.requests"' in out


def test_serve_defaults_to_the_card():
    """--device defaults to cuda: without a card it raises and says to pass
    --device cpu (nothing falls back to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="--device cpu"):
        serve.main(["--smoke"])
