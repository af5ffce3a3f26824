"""The port's threefry PRNG against ``jax.random`` (JAX 0.9.0,
``jax_threefry_partitionable=True``), on the CPU.

Bitwise: keys from ``PRNGKey``, ``fold_in`` and ``split``, ``bits``, the
bit patterns of ``uniform`` and ``bernoulli`` masks, over seeds at the
int32 / uint32 / int64 edges, odd sizes and sizes above 2^16, and batches
of keys (the JAX package maps one key with ``jax.vmap``). Gumbel noise
within a relative 2e-6 of max(1, |g|) (``log`` rounds differently in the
two libraries); categorical draws equal except where the reference's
top-2 gap of ``logits + gumbel`` is below 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro_torch import prng
import torch_threads  # noqa: F401  (torch threads per xdist worker)

# taken from JAX 0.9.0 in this repository's test environment
KNOWN = {
    "PRNGKey(7)": [0, 7],
    "fold_in(PRNGKey(7), 3)": [276534068, 1641862660],
    "split(PRNGKey(7), 3)": [[3625411723, 1954958720], [195045567, 4062205631],
                             [966301609, 1948237315]],
    "bits(PRNGKey(1234), (4,))": [3715183467, 3461522409, 1578076316,
                                  3641478021],
    "uniform(PRNGKey(1234), (4,)) bits": [1063088434, 1062097570, 1052516112,
                                          1062800522],
    "categorical(PRNGKey(1234), log [.1 .2 .3 .4])": 3,
}
SEEDS = [0, 1, 2 ** 31 - 1, 2 ** 31, -1, -2 ** 31, 2 ** 32 + 5, 2 ** 63 - 1,
         -2 ** 63]
SHAPES = [(1,), (5,), (3, 5), (2, 3, 7), (65537,), (70001,)]


def jkey(seed):
    return jax.random.PRNGKey(seed)


def tkey(seed):
    return prng.PRNGKey(seed)


def words(a) -> np.ndarray:
    """uint32 JAX words as int64, the port's representation."""
    return np.asarray(a).astype(np.int64)


def test_known_answers():
    k = prng.PRNGKey(7)
    assert k.tolist() == KNOWN["PRNGKey(7)"]
    assert prng.fold_in(k, 3).tolist() == KNOWN["fold_in(PRNGKey(7), 3)"]
    assert prng.split(k, 3).tolist() == KNOWN["split(PRNGKey(7), 3)"]
    k = prng.PRNGKey(1234)
    assert prng.bits(k, (4,)).tolist() == KNOWN["bits(PRNGKey(1234), (4,))"]
    assert prng.uniform(k, (4,)).view(torch.int32).tolist() == \
        KNOWN["uniform(PRNGKey(1234), (4,)) bits"]
    logp = torch.log(torch.tensor([0.1, 0.2, 0.3, 0.4]))
    assert prng.categorical(k, logp).item() == \
        KNOWN["categorical(PRNGKey(1234), log [.1 .2 .3 .4])"]
    # and the installed reference still gives them
    assert words(jax.random.split(jkey(7), 3)).tolist() == \
        KNOWN["split(PRNGKey(7), 3)"]


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_matches_jax(seed):
    np.testing.assert_array_equal(tkey(seed).numpy(), words(jkey(seed)))


@pytest.mark.parametrize("seed", [2 ** 63, -2 ** 63 - 1, 2 ** 64])
def test_prng_key_refuses_what_jax_refuses(seed):
    with pytest.raises(OverflowError):
        jkey(seed)
    with pytest.raises(OverflowError):
        tkey(seed)


@pytest.mark.parametrize("seed,data", [(0, 0), (7, 3), (-1, 2 ** 32 - 1),
                                       (2 ** 31 - 1, 517), (123, 2 ** 31)])
def test_fold_in_matches_jax(seed, data):
    np.testing.assert_array_equal(prng.fold_in(tkey(seed), data).numpy(),
                                  words(jax.random.fold_in(jkey(seed), data)))


def test_fold_in_refuses_out_of_range_data():
    for data in (-1, 2 ** 32):
        with pytest.raises(OverflowError):
            prng.fold_in(tkey(0), data)


@pytest.mark.parametrize("num", [1, 2, 3, 7, 64])
def test_split_matches_jax(num):
    for seed in (0, 5, -1):
        np.testing.assert_array_equal(
            prng.split(tkey(seed), num).numpy(),
            words(jax.random.split(jkey(seed), num)))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_bits_and_uniform_match_jax(shape):
    for seed in (0, 99):
        np.testing.assert_array_equal(prng.bits(tkey(seed), shape).numpy(),
                                      words(jax.random.bits(jkey(seed), shape)))
        got = prng.uniform(tkey(seed), shape).numpy()
        want = np.asarray(jax.random.uniform(jkey(seed), shape))
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("lo,hi", [(np.finfo(np.float32).tiny, 1.0),
                                   (-2.0, 3.0), (0.25, 0.5)])
def test_uniform_range_bit_patterns(lo, hi):
    got = prng.uniform(tkey(3), (1000,), lo, hi).numpy()
    want = np.asarray(jax.random.uniform(jkey(3), (1000,), minval=lo,
                                         maxval=hi))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("p", [0.9, 0.5, 0.1])
@pytest.mark.parametrize("shape", [(2, 24, 16), (70001,)], ids=str)
def test_bernoulli_masks_match_jax(p, shape):
    got = prng.bernoulli(tkey(11), p, shape).numpy()
    want = np.asarray(jax.random.bernoulli(jkey(11), p, shape))
    np.testing.assert_array_equal(got, want)


def test_batched_keys_match_vmap():
    """(B, 2) keys: each row is the JAX call on that key."""
    jk = jax.random.split(jkey(4), 5)
    tk = torch.from_numpy(words(jk))
    pos = np.array([0, 1, 517, 2 ** 31 - 1, 9], np.int32)
    np.testing.assert_array_equal(
        prng.fold_in(tk, torch.from_numpy(pos)).numpy(),
        words(jax.vmap(jax.random.fold_in)(jk, jnp.asarray(pos))))
    np.testing.assert_array_equal(
        prng.split(tk, 3).numpy(),
        words(jax.vmap(lambda k: jax.random.split(k, 3))(jk)))
    got = prng.uniform(tk, (3, 4)).numpy().view(np.int32)
    want = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (3, 4)))(jk))
    np.testing.assert_array_equal(got, want.view(np.int32))


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(-2 ** 63, 2 ** 63 - 1),
       pos=st.integers(0, 2 ** 32 - 1), n=st.integers(1, 300))
def test_streams_match_jax_over_seeds_and_positions(seed, pos, n):
    tk = prng.fold_in(tkey(seed), pos)
    jk = jax.random.fold_in(jkey(seed), pos)
    np.testing.assert_array_equal(tk.numpy(), words(jk))
    np.testing.assert_array_equal(prng.bits(tk, (n,)).numpy(),
                                  words(jax.random.bits(jk, (n,))))


@pytest.mark.parametrize("shape", [(7,), (3, 5000), (70001,)], ids=str)
def test_gumbel_within_tolerance(shape):
    got = prng.gumbel(tkey(21), shape).numpy()
    want = np.asarray(jax.random.gumbel(jkey(21), shape))
    err = np.abs(got - want) / np.maximum(1.0, np.abs(want))
    assert err.max() <= 2e-6, err.max()


def test_categorical_draws_match_jax():
    """2048 keys drawing from fixed probabilities over 50 tokens."""
    rng = np.random.default_rng(0)
    p = rng.dirichlet(np.full(50, 0.3), 4).astype(np.float32)
    jk = jax.random.split(jkey(8), 2048)
    tk = torch.from_numpy(words(jk))
    for row in p:
        logp = np.log(row)
        want = np.asarray(jax.vmap(
            lambda k: jax.random.categorical(k, jnp.asarray(logp)))(jk))
        got = prng.categorical(tk, torch.from_numpy(logp)[None]).numpy()
        pert = np.sort(np.asarray(jax.vmap(
            lambda k: jax.random.gumbel(k, (50,)))(jk)) + logp, -1)
        near = (pert[:, -1] - pert[:, -2]) < 1e-5
        np.testing.assert_array_equal(got[~near], want[~near])
        assert (got == want).mean() > 0.999
