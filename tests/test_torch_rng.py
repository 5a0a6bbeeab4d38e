"""Port parity: counter hash, counter gaussians and threefry keys of
``repro_torch`` against the JAX package, on the CPU.

Tolerances: the hash and the keys are integer functions and must agree bit
for bit. The gaussians go through f32 log and cos, whose last bits differ
between XLA's CPU code and numpy's (the port's CPU Box-Muller): max |Δ| is
4.8e-7 (one f32 ulp at |u| ~ 4) over 10^6 draws. Every draw must be
within GAUSS_TOL = 1e-5, twenty such ulps; a wrong stream, salt or offset
moves draws by O(1).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.core import prng
from repro_torch.kernels import ref as tref

GAUSS_TOL = 1e-5


def assert_gauss_close(got, want):
    assert np.abs(np.asarray(got) - np.asarray(want)).max() <= GAUSS_TOL


def _u32(rng, n, high=2 ** 32):
    return rng.integers(0, high, size=n, dtype=np.uint32)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def test_hash_u32_bit_exact():
    rng = np.random.default_rng(0)
    seed, idx = _u32(rng, 8192), _u32(rng, 8192)
    seed[:4] = [0, 0xFFFFFFFF, 0, 0xFFFFFFFF]
    idx[:4] = [0, 0, 0xFFFFFFFF, 0xFFFFFFFF]
    want = np.asarray(jref._hash_u32(jnp.asarray(seed), jnp.asarray(idx)))
    got = tref._hash_u32(_t(seed), _t(idx)).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("seed", [0, 12345, 0xFFFFFFFF])
def test_counter_gauss2_close(seed):
    rng = np.random.default_rng(seed & 0xFFFF)
    hi, lo = _u32(rng, 100_000), _u32(rng, 100_000, tref.LANE)
    want = np.asarray(jref.counter_gauss2(np.uint32(seed), jnp.asarray(hi),
                                          jnp.asarray(lo)))
    got = tref.counter_gauss2(seed, _t(hi), _t(lo)).numpy()
    assert_gauss_close(got, want)


@pytest.mark.parametrize("seed,row0", [(7, 0), (0xDEADBEEF, 37),
                                       (3, 0xFFFFFFF0)])
def test_noise_rows_close(seed, row0):
    """Row offsets past 2**32 wrap as uint32 in both packages."""
    want = np.asarray(jref.noise_rows(np.uint32(seed), row0, 32))
    got = tref.noise_rows(seed, row0, 32).numpy()
    assert got.shape == (32, tref.LANE)
    assert_gauss_close(got, want)


def _seed_data_pairs():
    rng = np.random.default_rng(1)
    seeds = [0, 1, 42, 2 ** 31 - 1] + rng.integers(0, 2 ** 31, 16).tolist()
    data = [0, 1, 7, 2 ** 32 - 1] + rng.integers(0, 2 ** 32, 6).tolist()
    return [(s, d) for s in seeds for d in data]   # 200 pairs


def test_prng_key_fold_in_split_bit_exact():
    for seed, data in _seed_data_pairs():
        kj = jax.random.PRNGKey(seed)
        kt = prng.PRNGKey(seed)
        np.testing.assert_array_equal(kt, np.asarray(kj))
        np.testing.assert_array_equal(prng.fold_in(kt, data),
                                      np.asarray(jax.random.fold_in(kj, data)))
    for seed in (0, 5, 2 ** 31 - 1):
        for num in (1, 2, 5):
            np.testing.assert_array_equal(
                prng.split(prng.PRNGKey(seed), num),
                np.asarray(jax.random.split(jax.random.PRNGKey(seed), num)))


def test_fold_in_chain_matches_round_records():
    """The record chain of a round: round -> client -> server step ->
    perturbation, then record_seeds = key[0] ^ key[-1]."""
    from repro.core import zo as jzo
    from repro_torch.core import zo as tzo
    kj, kt = jax.random.PRNGKey(3), prng.PRNGKey(3)
    for d in (5, 1, 0, 2):
        kj, kt = jax.random.fold_in(kj, d), prng.fold_in(kt, d)
    assert int(jzo.record_seeds(kj)) == int(tzo.record_seeds(kt))
