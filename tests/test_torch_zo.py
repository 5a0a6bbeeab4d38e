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


def test_other_dists_not_ported(server_tree):
    _, tt = server_tree
    for dist in ("gaussian", "sphere"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
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
