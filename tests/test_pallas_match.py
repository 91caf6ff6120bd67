"""Hamming matcher: the two XLA distance forms are bit-exact, and 2-NN +
ratio + mutual-nearest selection agrees with a NumPy brute force."""

import jax.numpy as jnp
import numpy as np
import pytest

from rgbdslam.frontend.matcher import match_descriptors
from rgbdslam.ops import hamming


def _descriptors(rng, n, m):
    d1 = rng.integers(0, 2**32, size=(n, 8), dtype=np.uint32)
    d2 = rng.integers(0, 2**32, size=(m, 8), dtype=np.uint32)
    return d1, d2, rng.random(n) > 0.1, rng.random(m) > 0.1


_BYTE_POP = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None],
                          axis=1).sum(axis=1)


def hamming_f64(d1, d2, v1, v2):
    """Brute-force distance matrix (byte popcount table), BIG for invalid."""
    x = (d1[:, None, :] ^ d2[None, :, :]).view(np.uint8)   # (n, m, 32)
    D = _BYTE_POP[x].sum(axis=-1, dtype=np.int64)
    return np.where(v1[:, None] & v2[None, :], D, hamming.BIG_DIST)


@pytest.mark.parametrize("n,m", [(384, 512), (1024, 1024)])
def test_mxu_form_bit_exact_vs_popcount(n, m):
    """The matmul identity d = pop(a)+pop(b)-2*<bits(a),bits(b)> must be
    bit-exact against the XOR+popcount form, including validity masking."""
    d1, d2, v1, v2 = [jnp.asarray(x) for x in
                      _descriptors(np.random.default_rng(7), n, m)]
    a = hamming.hamming_distance_matrix(d1, d2, v1, v2, impl="popcount")
    b = hamming.hamming_distance_matrix(d1, d2, v1, v2, impl="mxu")
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # knn2 epilogue on the same matrix is deterministic (same argmin path)
    for x, y in zip(hamming.knn2(a), hamming.knn2(b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_unknown_impl_raises():
    d = jnp.zeros((4, 8), jnp.uint32)
    with pytest.raises(ValueError):
        hamming.hamming_distance_matrix(d, d, impl="pallas")


@pytest.mark.parametrize("n,m", [(64, 96), (256, 256), (1000, 1000)])
def test_knn2_matches_numpy_brute_force(n, m):
    d1, d2, v1, v2 = _descriptors(np.random.default_rng(n), n, m)
    D = hamming_f64(d1, d2, v1, v2)
    got = hamming.hamming_distance_matrix(
        jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(v1), jnp.asarray(v2))
    np.testing.assert_array_equal(np.asarray(got), D)
    bi, bd, sd = [np.asarray(x) for x in hamming.knn2(got)]
    np.testing.assert_array_equal(bd, D.min(axis=1))
    # argmin ties may pick another column; its distance must be the best
    np.testing.assert_array_equal(D[np.arange(n), bi], D.min(axis=1))
    D2 = D.copy()
    D2[np.arange(n), bi] = hamming.BIG_DIST
    np.testing.assert_array_equal(sd, D2.min(axis=1))


def match_f64(d1, v1, d2, v2, ratio):
    """NumPy brute force of 2-NN + Lowe ratio + mutual-nearest dedup."""
    D = hamming_f64(d1, d2, v1, v2)
    bi = D.argmin(axis=1)
    bd = D.min(axis=1)
    D2 = D.copy()
    D2[np.arange(len(d1)), bi] = hamming.BIG_DIST
    sd = D2.min(axis=1)
    col_best = D.argmin(axis=0)
    mutual = col_best[bi] == np.arange(len(d1))
    ok = (bd < ratio * sd) & mutual & v1 & (bd < hamming.BIG_DIST)
    return bi, ok


@pytest.mark.parametrize("n", [128, 256, 1024])
def test_match_descriptors_matches_numpy(n):
    """Frame 2 is a permuted, bit-flipped copy of frame 1: the matcher keeps
    exactly the pairs the brute force keeps, and recovers the
    permutation."""
    rng = np.random.default_rng(n + 1)
    base = rng.integers(0, 2**32, size=(n, 8), dtype=np.uint32)
    perm = rng.permutation(n)
    d2 = base[perm].copy()
    flip = rng.integers(0, 2**32, size=(n, 8), dtype=np.uint32)
    d2 ^= flip & rng.integers(0, 2, size=(n, 8), dtype=np.uint32)
    v1 = rng.random(n) > 0.05
    v2 = rng.random(n) > 0.05

    m = match_descriptors(jnp.asarray(base), jnp.asarray(v1),
                          jnp.asarray(d2), jnp.asarray(v2), 0.9)
    bi, ok = match_f64(base, v1, d2, v2, 0.9)
    valid = np.asarray(m.valid)
    np.testing.assert_array_equal(valid, ok)
    np.testing.assert_array_equal(np.asarray(m.idx2)[valid], bi[valid])
    inv = np.argsort(perm)
    assert (bi[valid] == inv[valid]).mean() > 0.95
