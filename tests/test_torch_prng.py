"""The port's threefry PRNG (tpu_bootstrap_torch/workload/prng.py) and its
sampling filters (decode._filter_logits) held to jax.random and to the
reference's decode._filter_logits on the CPU.

The integer half is held bit for bit: PRNGKey over the seeds jax accepts,
fold_in chains (scalar and per row, jax.vmap's form), split, 32-bit bits
of one and two dimensions, uniform. gumbel takes two logs, which torch and
XLA may round an ulp apart: it is held within GUMBEL_ULPS ulps of the
larger of its magnitude and 1. categorical
draws equal jax's except where the top two of logits + gumbel lie within
NEAR_TIE (none occur at these seeds). The filters keep the same entries as
the reference's on ties, on top_k at and past the vocabulary, and on
top_p at the cumulative masses of the sorted distribution.

The partitionable threefry paths are what the port mirrors; a first test
pins jax's flag, so that a jax upgrade that flips it fails here."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_bootstrap.workload import decode as jdecode
from tpu_bootstrap_torch.workload import decode as tdecode
from tpu_bootstrap_torch.workload import prng

torch.set_num_threads(2)

GUMBEL_ULPS = 4  # ulps of max(|x|, 1); measured at most 2 over 64k draws
NEAR_TIE = 1e-5  # f32 logits + gumbel, the categorical's near-tie


def _np(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.uint32)


def _key(seed: int):
    return jax.random.PRNGKey(seed), prng.key(seed)


def test_threefry_partitionable_flag_is_on():
    assert jax.config.jax_threefry_partitionable is True


@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 - 1, 2**32 - 1, 2**32,
                                  2**63 - 1, -1, -2**31, -2**63])
def test_prng_key_matches_jax(seed):
    jk, tk = _key(seed)
    np.testing.assert_array_equal(_np(tk), np.asarray(jk))


@pytest.mark.parametrize("seed", [2**63, 2**64 - 1, -2**63 - 1])
def test_prng_key_refuses_what_jax_refuses(seed):
    with pytest.raises(OverflowError):
        jax.random.PRNGKey(seed)
    with pytest.raises(OverflowError):
        prng.key(seed)


def test_fold_in_chain_and_rows_match_jax():
    jk, tk = _key(7)
    for d in [0, 1, 5, 2**31 - 1, 2**32 - 1, 123456789]:
        jk, tk = jax.random.fold_in(jk, d), prng.fold_in(tk, d)
        np.testing.assert_array_equal(_np(tk), np.asarray(jk))
    rows = jnp.stack([jax.random.fold_in(jk, i) for i in range(6)])
    data = np.array([0, 3, 9, 2**31, 2**32 - 1, 17], np.uint32)
    want = jax.vmap(jax.random.fold_in)(rows, data)
    got = prng.fold_in(prng.as_key(rows), torch.tensor(data.astype(np.int64)))
    np.testing.assert_array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("n", [1, 2, 3, 4, 17])
def test_split_matches_jax(n):
    jk, tk = _key(11)
    np.testing.assert_array_equal(_np(prng.split(tk, n)),
                                  np.asarray(jax.random.split(jk, n)))


@pytest.mark.parametrize("shape", [(1,), (64,), (1000,), (3, 7), (8, 64)])
def test_bits_match_jax(shape):
    jk, tk = _key(3)
    np.testing.assert_array_equal(_np(prng.bits32(tk, shape)),
                                  np.asarray(jax.random.bits(jk, shape)))


def test_bits_of_row_keys_match_vmapped_jax():
    jk, _ = _key(9)
    rows = jax.random.split(jk, 5)
    want = jax.vmap(lambda k: jax.random.bits(k, (33,)))(rows)
    np.testing.assert_array_equal(_np(prng.bits32(prng.as_key(rows),
                                                  (33,))),
                                  np.asarray(want))


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-2.0, 3.0),
                                   (float(np.finfo(np.float32).tiny), 1.0)])
def test_uniform_matches_jax_bitwise(lo, hi):
    jk, tk = _key(21)
    want = np.asarray(jax.random.uniform(jk, (4, 257), minval=lo,
                                         maxval=hi))
    got = prng.uniform(tk, (4, 257), minval=lo, maxval=hi).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_gumbel_within_ulps_of_jax():
    jk, tk = _key(5)
    want = np.asarray(jax.random.gumbel(jk, (64, 1024)))
    got = prng.gumbel(tk, (64, 1024)).numpy()
    # In ulps of the larger of |x| and 1: near 0 the logs' absolute error
    # is what an ulp of 1 measures.
    ulps = np.abs(got - want) / np.spacing(np.maximum(np.abs(want),
                                                      np.float32(1)))
    assert ulps.max() <= GUMBEL_ULPS, ulps.max()
    assert (got == want).mean() > 0.5


def _near_tie_rows(logits, g):
    z = np.sort(logits + g, axis=-1)
    return (z[..., -1] - z[..., -2]) < NEAR_TIE


def test_categorical_matches_jax_except_near_ties():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((16, 97)).astype(np.float32) * 3
    jk, tk = _key(13)
    want = np.asarray(jax.random.categorical(jk, logits, axis=-1))
    got = prng.categorical(tk, torch.tensor(logits)).numpy()
    ties = _near_tie_rows(logits, np.asarray(jax.random.gumbel(
        jk, logits.shape)))
    assert not ties.any()
    np.testing.assert_array_equal(got, want)
    # Per-row keys: jax.vmap(jax.random.categorical).
    rows = jax.random.split(jk, 16)
    want = np.asarray(jax.vmap(jax.random.categorical)(rows, logits))
    got = prng.categorical(prng.as_key(rows), torch.tensor(logits)).numpy()
    np.testing.assert_array_equal(got, want)
    # -inf entries are never drawn.
    masked = logits.copy()
    masked[:, 1:] = -np.inf
    assert (prng.categorical(tk, torch.tensor(masked)).numpy() == 0).all()


# ---- the sampling filters ------------------------------------------------


def _filters_equal(logits: np.ndarray, top_k: int, top_p: float):
    want = np.asarray(jdecode._filter_logits(jnp.asarray(logits), top_k,
                                             top_p))
    got = tdecode._filter_logits(torch.tensor(logits), top_k, top_p).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    np.testing.assert_array_equal(got[np.isfinite(got)],
                                  want[np.isfinite(want)])
    return got


def test_filter_logits_reference_cases():
    """The reference's own cases (test_decode.py:78): top_k keeps the two
    largest, a nucleus of 0.7 keeps 0.5 + 0.25, a tiny nucleus keeps the
    argmax."""
    logits = np.log(np.array([[0.5, 0.25, 0.15, 0.07, 0.03]], np.float32))
    f = _filters_equal(logits, 2, 1.0)
    assert np.isfinite(f[0, :2]).all() and np.isneginf(f[0, 2:]).all()
    f = _filters_equal(logits, 0, 0.7)
    assert np.isfinite(f[0, :2]).all() and np.isneginf(f[0, 2:]).all()
    f = _filters_equal(logits, 0, 1e-6)
    assert np.isfinite(f[0, 0]) and np.isneginf(f[0, 1:]).all()


@pytest.mark.parametrize("top_k", [1, 2, 3, 5, 6, 100])
def test_filter_top_k_keeps_ties_and_clamps(top_k):
    """Ties at the k-th value all survive; k at or past the vocabulary
    keeps everything."""
    logits = np.array([[1.0, 3.0, 3.0, 0.5, 3.0, -1.0],
                       [2.0, 2.0, 2.0, 2.0, 2.0, 2.0]], np.float32)
    f = _filters_equal(logits, top_k, 1.0)
    if top_k >= 6:
        assert np.isfinite(f).all()
    if top_k in (1, 2, 3):
        assert np.isfinite(f[0]).sum() == 3  # the three tied 3.0s
    assert np.isfinite(f[1]).all()  # one value: every entry ties


@pytest.mark.parametrize("top_p", [0.25, 0.4, 0.5, 0.7, 0.75, 0.9,
                                   0.9000001, 1.0])
def test_filter_top_p_at_mass_boundaries(top_p):
    """p on and beside the cumulative masses of the sorted distribution
    (0.4, 0.7, 0.9 before the last entries here): an entry survives while
    the mass before it is below p, the top one always; tied logits share
    one fate; p = 1 keeps everything."""
    for probs in ([0.4, 0.3, 0.2, 0.1], [0.25, 0.25, 0.25, 0.25],
                  [0.1, 0.4, 0.1, 0.2, 0.2]):
        logits = np.log(np.array([probs], np.float32))
        f = _filters_equal(logits, 0, top_p)
        assert np.isfinite(f[0, int(np.argmax(logits))])


def test_filters_on_random_logits_match_the_reference():
    """Both filters over random rows (a vocabulary of 300, scaled as a
    temperature would), away from the nucleus's mass boundaries: the same
    entries kept."""
    rng = np.random.default_rng(1)
    logits = (rng.standard_normal((32, 300)) * 2.5).astype(np.float32)
    for top_k, top_p in [(0, 0.9), (40, 1.0), (40, 0.8), (300, 0.5),
                         (7, 0.99)]:
        _filters_equal(logits, top_k, top_p)
