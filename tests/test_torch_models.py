"""Port parity: the dense model of ``repro_torch`` against
``repro.models`` for the SMOKE configs of the ported dense decoders (the
LayerNorm models olmo-1b and paper-opt-1.3b; the RMSNorm models qwen3-14b
with qk-norm, internlm2-1.8b, and mistral-nemo-12b with d_head decoupled
from d_model / n_heads), with the reference's parameters carried across by
``convert.from_jax_params``.

Tolerances. f32 (``cfg.replace(dtype='float32')``): h within 1e-5 and the
loss within 1e-5 (measured: 2.4e-6 and 4.8e-7; the attention sums run in
another order). bf16: the reference casts the attention probabilities to
bf16 before P·V, while the port's flash function keeps them in f32, so h
drifts by a few bf16 ulps per layer (measured 0.047 at |h| <= 3.9 after
three layers, 1.2% of the largest value); held to 2^-5 of max|h|, and the
loss (measured 4.1e-4 apart) to 2e-3. With qk-norm (qwen3-14b) the loss
is held to 5e-3 instead: q and k are normalised in f32 and rounded to
bf16, where a one-ulp difference in the f32 mean of squares (sums in
another order) flips a bf16 rounding, and the unit-RMS q and k carry it
into every logit. Measured 2.8e-3 at the test's parameters (0.6e-3 and
2.1e-3 at two other init seeds; the same model without qk-norm 0.07e-3 to
0.37e-3), whether or not the probabilities are cast to bf16 before P·V.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import client_forward as j_client
from repro.models import init_params as j_init
from repro.models import server_forward as j_server
from repro.models import split_params as j_split
from repro.models import untie_params as j_untie
from repro_torch.configs import get_config as t_get_config
from repro_torch.models import client_forward, server_forward, split_params
from repro_torch.models.convert import from_jax_params, to_jax_params
from repro_torch.utils import tree

TOLS = {"float32": (1e-5, 1e-5), "bfloat16": (2.0 ** -5, 2e-3)}
QK_NORM_BF16_LOSS_TOL = 5e-3


@pytest.fixture(scope="module", params=["olmo-1b", "paper-opt-1.3b",
                                        "qwen3-14b", "internlm2-1.8b",
                                        "mistral-nemo-12b"])
def arch(request):
    return request.param


@functools.lru_cache(maxsize=None)
def _setup(arch, dtype):
    jcfg = j_get_config(arch, smoke=True).replace(dtype=dtype)
    tcfg = t_get_config(arch, smoke=True).replace(dtype=dtype)
    params = j_untie(jcfg, j_init(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jcfg.vocab_size, size=(2, 32)).astype(np.int32)
    labels = rng.integers(0, jcfg.vocab_size, size=(2, 32)).astype(np.int32)
    labels[0, :3] = -1                     # ignored positions
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.from_numpy(toks.astype(np.int64)),
          "labels": torch.from_numpy(labels.astype(np.int64))}
    return jcfg, tcfg, params, from_jax_params(params), jb, tb


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cut", [1, 2, 3])
def test_forward_halves_match_reference(arch, dtype, cut):
    jcfg, tcfg, jp, tp, jb, tb = _setup(arch, dtype)
    h_tol, loss_tol = TOLS[dtype]
    if dtype == "bfloat16" and jcfg.qk_norm:
        loss_tol = QK_NORM_BF16_LOSS_TOL
    jc, js = j_split(jcfg, jp, cut)
    tc, ts = split_params(tcfg, tp, cut)
    jh = j_client(jcfg, jc, jb)
    th = client_forward(tcfg, tc, tb)
    want_h = np.asarray(jh["h"], np.float32)
    dh = np.abs(th["h"].to(torch.float32).numpy() - want_h).max()
    if dtype == "bfloat16":
        h_tol *= np.abs(want_h).max()
    assert dh <= h_tol
    loss = server_forward(tcfg, ts, th, tb)
    assert loss.dtype == torch.float32 and loss.shape == ()
    assert abs(float(loss) - float(j_server(jcfg, js, jh, jb))) <= loss_tol


def test_configs_match_reference(arch):
    for smoke in (False, True):
        j = j_get_config(arch, smoke=smoke)
        t = t_get_config(arch, smoke=smoke)
        assert t.__dict__ == j.__dict__


def test_unported_arch_names_roadmap():
    with pytest.raises(KeyError, match="ROADMAP"):
        t_get_config("mixtral-8x22b")


def test_converter_round_trip(arch):
    """numpy tree -> tensors -> numpy tree keeps every bit, bf16 included,
    and keeps the empty norm dicts of OLMo."""
    jcfg = j_get_config(arch, smoke=True)
    params = j_untie(jcfg, j_init(jcfg, jax.random.PRNGKey(1)))
    back = to_jax_params(from_jax_params(params))
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.view(np.uint8),
                                      np.asarray(b).view(np.uint8))
    t = from_jax_params(params)
    assert tree.leaves(t)[0].dtype in (torch.bfloat16, torch.float32)
    # the port flattens in jax.tree.flatten order (the noise salt is the
    # leaf index); norm scales (RMSNorm, qk-norm) stay f32 in a bf16 model
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    for (path, a), b in zip(flat, tree.leaves(t), strict=True):
        assert tuple(b.shape) == a.shape
        if "norm" in jax.tree_util.keystr(path):
            assert a.dtype == np.float32 and b.dtype == torch.float32


def test_decoupled_head_dim_matches_reference():
    """d_head ≠ d_model / n_heads (mistral-nemo-12b's 128 at 5120 / 32;
    the SMOKE config's 16 equals 64 / 4, so it is set to 32 here), with
    qk-norm over that width: f32 forward within the f32 tolerances."""
    kw = dict(d_head=32, qk_norm=True, dtype="float32")
    jcfg = j_get_config("mistral-nemo-12b", smoke=True).replace(**kw)
    tcfg = t_get_config("mistral-nemo-12b", smoke=True).replace(**kw)
    assert jcfg.d_head * jcfg.n_heads != jcfg.d_model
    params = j_untie(jcfg, j_init(jcfg, jax.random.PRNGKey(2)))
    _, _, _, _, jb, tb = _setup("mistral-nemo-12b", "float32")
    jc, js = j_split(jcfg, params, 2)
    tc, ts = split_params(tcfg, from_jax_params(params), 2)
    jh, th = j_client(jcfg, jc, jb), client_forward(tcfg, tc, tb)
    h_tol, loss_tol = TOLS["float32"]
    assert np.abs(th["h"].numpy() - np.asarray(jh["h"])).max() <= h_tol
    assert abs(float(server_forward(tcfg, ts, th, tb))
               - float(j_server(jcfg, js, jh, jb))) <= loss_tol
