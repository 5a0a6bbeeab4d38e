"""Port parity: counter-noise ZO estimation (``repro_torch.core.zo``)
against ``repro.core.zo`` on the server half of the olmo-1b SMOKE model in
f32. The tree has OLMo's empty norm dicts, so these tests pin the leaf
order that salts each leaf's noise.

Tolerances: the noise tree within NOISE_TOL = 1e-5 (f32 ulps of log/cos,
see test_torch_rng.py); perturbed
trees (scale 5e-3) and replayed trees (coefficients ~0.05) within 1e-5;
SPSA deltas are differences of two nearby losses and are held to 1e-4
relative, the new parameters to 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core import zo as jzo
from repro.models import init_params as j_init
from repro.models import split_params as j_split
from repro.models import untie_params as j_untie
from repro_torch.core import prng
from repro_torch.core import zo as tzo
from repro_torch.models.convert import from_jax_params, to_jax_params
from repro_torch.utils import tree

TOL = 1e-5
NOISE_TOL = 1e-5


def maxdiff(t_tree, j_tree):
    got = tree.leaves(to_jax_params(t_tree))
    want = jax.tree.leaves(j_tree)
    assert len(got) == len(want)
    return max(float(np.max(np.abs(np.asarray(g, np.float32)
                                   - np.asarray(w, np.float32))))
               for g, w in zip(got, want))


@pytest.fixture(scope="module")
def server_tree():
    cfg = j_get_config("olmo-1b", smoke=True).replace(dtype="float32")
    params = j_untie(cfg, j_init(cfg, jax.random.PRNGKey(0)))
    _, xs = j_split(cfg, params, 2)
    return xs, from_jax_params(xs)


def test_tree_order_matches_jax_flatten(server_tree):
    jt, tt = server_tree
    shapes_j = [x.shape for x in jax.tree.leaves(jt)]
    shapes_t = [tuple(x.shape) for x in tree.leaves(tt)]
    assert shapes_t == shapes_j
    assert tt["final_norm"] == {} and tt["units"]["b0"]["norm1"] == {}


def test_tree_noise_counter(server_tree):
    jt, tt = server_tree
    key = jax.random.PRNGKey(11)
    want = jzo.tree_noise(key, jt, "counter")
    got = tzo.tree_noise(np.asarray(key), tt, "counter")
    assert maxdiff(got, want) <= NOISE_TOL


def test_perturb_counter(server_tree):
    jt, tt = server_tree
    key = jax.random.fold_in(jax.random.PRNGKey(2), 9)
    for eps in (5e-3, -5e-3):
        want = jzo.perturb(jt, key, eps, "counter")
        got = tzo.perturb(tt, np.asarray(key), eps, "counter")
        assert maxdiff(got, want) <= TOL


def test_fused_replay_updates(server_tree):
    jt, tt = server_tree
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(5), i)
                    )(jnp.arange(6))
    coeffs = (np.random.default_rng(0).normal(size=6) * 0.05
              ).astype(np.float32)
    want = jzo.fused_replay_updates(jt, keys, jnp.asarray(coeffs), "counter")
    got = tzo.fused_replay_updates(tt, np.asarray(keys),
                                   torch.from_numpy(coeffs), "counter")
    assert maxdiff(got, want) <= TOL


def test_spsa_step_records_and_params(server_tree):
    jt, tt = server_tree

    def j_loss(p):
        return sum(jnp.sum(jnp.sin(x)) for x in jax.tree.leaves(p))

    def t_loss(p):
        return sum(torch.sin(x).sum() for x in tree.leaves(p))

    key = jax.random.PRNGKey(21)
    jp, jd, (jkeys, jc) = jzo.spsa_step(j_loss, jt, key, 1e-2, 1e-3, 2,
                                        dist="counter")
    tp, td, (tkeys, tc) = tzo.spsa_step(t_loss, tt, prng.PRNGKey(21), 1e-2,
                                        1e-3, 2, dist="counter")
    np.testing.assert_array_equal(tkeys, np.asarray(jkeys))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-4)
    np.testing.assert_allclose(float(td), float(jd), rtol=1e-4)
    assert maxdiff(tp, jp) <= TOL


THREEFRY_NOISE_TOL = 1e-6      # jax.random.normal, test_torch_threefry.py


def _few_term_losses():
    """A loss of the first 64 elements of each leaf, sin(3x): few terms,
    so the SPSA difference δ of two nearby losses keeps its digits in f32
    whatever order each side sums in."""
    def j_loss(p):
        return sum(jnp.sum(jnp.sin(3.0 * x.reshape(-1)[:64]))
                   for x in jax.tree.leaves(p))

    def t_loss(p):
        return sum(torch.sin(3.0 * x.reshape(-1)[:64]).sum()
                   for x in tree.leaves(p))
    return j_loss, t_loss


@pytest.mark.parametrize("dist", ["gaussian", "sphere"])
def test_threefry_noise_perturb_and_gradient(server_tree, dist):
    """tree_noise within the gaussian's tolerance of the reference's (the
    sphere after its √d/‖u‖ scaling over the whole tree), perturb (scale
    5e-3) within TOL, and zo_gradient (P=2) within 1e-5 of max|g|."""
    jt, tt = server_tree
    key = jax.random.PRNGKey(11)
    assert maxdiff(tzo.tree_noise(np.asarray(key), tt, dist),
                   jzo.tree_noise(key, jt, dist)) <= THREEFRY_NOISE_TOL
    for eps in (5e-3, -5e-3):
        assert maxdiff(tzo.perturb(tt, np.asarray(key), eps, dist),
                       jzo.perturb(jt, key, eps, dist)) <= TOL
    j_loss, t_loss = _few_term_losses()
    want = jzo.zo_gradient(j_loss, jt, key, 1e-2, 2, dist)
    got = tzo.zo_gradient(t_loss, tt, np.asarray(key), 1e-2, 2, dist)
    gmax = max(float(np.abs(np.asarray(g)).max())
               for g in jax.tree.leaves(want))
    assert maxdiff(got, want) <= 1e-5 * gmax


@pytest.mark.parametrize("dist", ["gaussian", "sphere"])
def test_threefry_spsa_step_and_replay(server_tree, dist):
    """spsa_step's records and new parameters, and fused_replay_updates,
    which takes the record-by-record path for threefry noise ('fused'
    refuses it, as in the reference)."""
    jt, tt = server_tree
    j_loss, t_loss = _few_term_losses()
    key = jax.random.PRNGKey(21)
    jp, jd, (jkeys, jc) = jzo.spsa_step(j_loss, jt, key, 1e-2, 1e-3, 2,
                                        dist=dist)
    tp, td, (tkeys, tc) = tzo.spsa_step(t_loss, tt, prng.PRNGKey(21), 1e-2,
                                        1e-3, 2, dist=dist)
    np.testing.assert_array_equal(tkeys, np.asarray(jkeys))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-4)
    np.testing.assert_allclose(float(td), float(jd), rtol=1e-4)
    assert maxdiff(tp, jp) <= TOL
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(5), i)
                    )(jnp.arange(4))
    coeffs = (np.random.default_rng(1).normal(size=4) * 0.05
              ).astype(np.float32)
    want = jzo.fused_replay_updates(jt, keys, jnp.asarray(coeffs), dist)
    got = tzo.fused_replay_updates(tt, np.asarray(keys),
                                   torch.from_numpy(coeffs), dist)
    assert maxdiff(got, want) <= TOL
    with pytest.raises(ValueError, match="counter"):
        tzo.fused_replay_updates(tt, np.asarray(keys),
                                 torch.from_numpy(coeffs), dist, impl="fused")


@pytest.mark.parametrize("dist", ["gaussian", "sphere"])
def test_replay_updates_bf16_matches_reference_scan(dist):
    """Six records on the bf16 server half, each cast to bf16 before the
    next, as the reference's lax.scan does: equal to the reference but for
    the few elements (at most 0.1%) where a gaussian up to 4.8e-7 off moved
    a rounding. Such a flip is one bf16 ulp of the value at that record,
    which later records keep as an absolute error, so each difference is
    held to two bf16 ulps of the larger of the element's first and last
    magnitudes."""
    cfg = j_get_config("olmo-1b", smoke=True)
    _, jt = j_split(cfg, j_untie(cfg, j_init(cfg, jax.random.PRNGKey(0))), 2)
    tt = from_jax_params(jt)
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(5), i)
                    )(jnp.arange(6))
    coeffs = (np.random.default_rng(0).normal(size=6) * 0.05
              ).astype(np.float32)
    want = jax.tree.leaves(jzo.replay_updates(jt, keys, jnp.asarray(coeffs),
                                              dist))
    got = tree.leaves(to_jax_params(tzo.replay_updates(
        tt, np.asarray(keys), torch.from_numpy(coeffs), dist)))
    n_diff = n = 0
    for g, w, x0 in zip(got, want, jax.tree.leaves(jt)):
        assert g.dtype == w.dtype == jnp.bfloat16
        g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
        mag = np.maximum(np.abs(np.asarray(x0, np.float32)),
                         np.maximum(np.abs(g), np.abs(w)))
        d = np.abs(g - w)
        assert (d <= 2.0 ** -6 * mag).all()
        n_diff += int((d > 0).sum())
        n += g.size
    assert n_diff <= 1e-3 * n, (n_diff, n)


def test_other_dists_not_ported(server_tree):
    """The reference's three dists are ported; any other name raises,
    naming them, where the reference would fall through to a gaussian."""
    _, tt = server_tree
    assert tzo.DISTS == ("gaussian", "sphere", "counter")
    for dist in ("uniform", "rademacher"):
        with pytest.raises(ValueError, match="gaussian"):
            tzo.perturb(tt, prng.PRNGKey(0), 1e-3, dist)


def test_tree_walks_hold_no_leaves():
    """flatten / tree_map leave no reference cycle behind that would keep
    a tree's tensors alive until the garbage collector runs."""
    import gc
    import weakref
    gc.collect()
    gc.disable()
    try:
        x = torch.zeros(4)
        ref = weakref.ref(x)
        tree.tree_map(lambda a: a + 1, {"a": {"b": x}, "c": {}})
        tree.flatten({"a": x})
        del x
        assert ref() is None
    finally:
        gc.enable()
