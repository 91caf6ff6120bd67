"""Hamming distance matrix + 2-NN over packed 256-bit descriptors.

Array-program replacement of cv::BFMatcher::knnMatch with NORM_HAMMING
(Features/Matcher.cpp:113). Two bit-exact formulations of the N x M
contraction:

- ``popcount``: XOR + population count over the packed words, an
  elementwise workload that XLA fuses with its row reductions.
- ``mxu``: the matmul identity  d(i,j) = pop(a_i) + pop(b_j) - 2 * common
  where ``common = bits(a) @ bits(b)^T`` is one (N, 32W) x (32W, M) int8
  matmul with int32 accumulation (a tensor-core product on the GPU).

Distances use int32; invalid descriptor slots are masked to BIG_DIST.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

BIG_DIST = 1 << 20
# on an H100 the two forms take the same device time in the VO step, and
# popcount needs a third of the launches (PERF.md, Findings)
DEFAULT_IMPL = "popcount"


def unpack_bits(desc: jnp.ndarray) -> jnp.ndarray:
    """(N, W) packed uint words -> (N, W * bits_per_word) int8 of 0/1.

    Bit order (LSB-first within each word) is irrelevant to the distance —
    both operands unpack identically.
    """
    n, w = desc.shape
    nbits = desc.dtype.itemsize * 8
    shifts = jnp.arange(nbits, dtype=desc.dtype)
    bits = (desc[:, :, None] >> shifts[None, None, :]) & desc.dtype.type(1)
    return bits.reshape(n, w * nbits).astype(jnp.int8)


def hamming_distance_matrix(
    desc1: jnp.ndarray,
    desc2: jnp.ndarray,
    valid1: jnp.ndarray | None = None,
    valid2: jnp.ndarray | None = None,
    impl: str | None = None,
) -> jnp.ndarray:
    """(N, W) uint32 x (M, W) uint32 -> (N, M) int32 Hamming distances.

    impl: 'popcount' or 'mxu' (default DEFAULT_IMPL); both are bit-exact.
    Invalid rows/cols are forced to BIG_DIST so downstream argmins never
    pick them.
    """
    impl = impl or DEFAULT_IMPL
    if impl == "mxu":
        common = jax.lax.dot_general(
            unpack_bits(desc1), unpack_bits(desc2),
            (((1,), (1,)), ((), ())),
            preferred_element_type=jnp.int32,
        )
        d = popcount_rows(desc1)[:, None] + popcount_rows(desc2)[None, :]
        d = d - 2 * common
    elif impl == "popcount":
        x = desc1[:, None, :] ^ desc2[None, :, :]  # (N, M, W)
        d = jnp.sum(jax.lax.population_count(x), axis=-1).astype(jnp.int32)
    else:
        raise ValueError(f"unknown Hamming impl {impl!r}")
    if valid1 is not None:
        d = jnp.where(valid1[:, None], d, BIG_DIST)
    if valid2 is not None:
        d = jnp.where(valid2[None, :], d, BIG_DIST)
    return d


def knn2(dist: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Per-row 2 nearest neighbors of a distance matrix.

    Returns (best_idx [N], best_dist [N], second_dist [N]). The runner-up is
    found by masking the winner's column with an iota compare, which fuses
    into the row reductions (a scatter epilogue would not).
    """
    best_idx = jnp.argmin(dist, axis=1).astype(jnp.int32)
    best_dist = jnp.min(dist, axis=1)
    col = jax.lax.broadcasted_iota(jnp.int32, dist.shape, 1)
    masked = jnp.where(col == best_idx[:, None], BIG_DIST, dist)
    second_dist = jnp.min(masked, axis=1)
    return best_idx, best_dist, second_dist


def popcount_rows(desc: jnp.ndarray) -> jnp.ndarray:
    """Row-wise popcount (number of set bits per descriptor)."""
    return jnp.sum(jax.lax.population_count(desc), axis=-1).astype(jnp.int32)
