"""Binary descriptor codebook: on-device k-majority clustering.

Replaces the DBoW3 vocabulary (`voc_TUM_FAST_BRIEF.yml.gz`, main.cpp:15,32 —
the file is not even shipped with the reference). Instead of an offline
hierarchical k-means tree, we train a flat codebook of V binary words by
k-majority (binary k-means): assign descriptors to the nearest word by Hamming
distance, recompute each word as the per-bit majority of its cluster. Flat
V-word quantization is a dense (N x V) popcount contraction — dense
elementwise work — so no tree traversal is needed.

The codebook can be trained on the fly from the first keyframes of the
sequence (the reference's vocabulary is dataset-specific anyway: TUM FAST-BRIEF).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from rgbdslam.ops import hamming


def quantize(desc: jnp.ndarray, words: jnp.ndarray,
             valid: jnp.ndarray | None = None) -> jnp.ndarray:
    """Nearest-word ids (N,) for descriptors against words (V, D).

    Binary (uint32-packed) descriptors use Hamming distance; float
    (SIFT/SURF-class, L2-normalized) descriptors use squared-L2 via one
    matmul — so every descriptor family of the reference factory gets a BoW
    path (Features/Extractor.h:13-26; DBoW3 itself is binary-only, this is
    beyond-reference for the float families)."""
    if desc.dtype == jnp.uint32:
        d = hamming.hamming_distance_matrix(desc, words, valid1=valid)
        return jnp.argmin(d, axis=1).astype(jnp.int32)
    # ||x - w||^2 = ||x||^2 - 2 x.w + ||w||^2; only the argmin matters
    dots = desc @ words.T                                  # (N, V)
    d = jnp.sum(words * words, axis=-1)[None, :] - 2.0 * dots
    if valid is not None:
        d = jnp.where(valid[:, None], d, jnp.inf)
    return jnp.argmin(d, axis=1).astype(jnp.int32)


def _unpack_bits(desc: jnp.ndarray) -> jnp.ndarray:
    """(N, 8) uint32 -> (N, 256) float32 bits."""
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = (desc[:, :, None] >> shifts[None, None, :]) & jnp.uint32(1)
    return bits.reshape(desc.shape[0], -1).astype(jnp.float32)


def _pack_bits(bits: jnp.ndarray) -> jnp.ndarray:
    """(V, 256) bool -> (V, 8) uint32."""
    v = bits.shape[0]
    b = bits.reshape(v, 8, 32).astype(jnp.uint32)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    return jnp.sum(b << shifts[None, None, :], axis=-1, dtype=jnp.uint32)


@functools.partial(jax.jit, static_argnums=(2, 3))
def train_codebook_float(
    desc: jnp.ndarray,
    valid: jnp.ndarray,
    vocab_size: int = 1024,
    iters: int = 8,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Deterministic Lloyd k-means for float descriptor families
    (SIFT/SURF-class): maxmin seeding + mean recomputation, L2 metric.
    Returns (words (V, D) f32, idf (V,) f32) like train_codebook."""
    first = jnp.argmax(valid)

    def d2_to(w):
        diff = desc - w[None, :]
        return jnp.sum(diff * diff, axis=-1)

    def pick(carry, _):
        min_d, = carry
        idx = jnp.argmax(jnp.where(valid, min_d, -1.0))
        w = desc[idx]
        return (jnp.minimum(min_d, d2_to(w)),), w

    (_,), rest = jax.lax.scan(
        pick, (d2_to(desc[first]),), None, length=vocab_size - 1
    )
    words = jnp.concatenate([desc[first][None], rest], axis=0)
    wmask = valid.astype(jnp.float32)

    def step(words, _):
        assign = quantize(desc, words, valid)
        onehot = jax.nn.one_hot(assign, vocab_size,
                                dtype=jnp.float32) * wmask[:, None]
        counts = onehot.sum(axis=0)
        sums = onehot.T @ desc
        new_words = sums / jnp.maximum(counts, 1.0)[:, None]
        return jnp.where((counts > 0)[:, None], new_words, words), None

    words, _ = jax.lax.scan(step, words, None, length=iters)
    assign = quantize(desc, words, valid)
    onehot = jax.nn.one_hot(assign, vocab_size,
                            dtype=jnp.float32) * wmask[:, None]
    df = onehot.sum(axis=0)
    n_valid = jnp.maximum(wmask.sum(), 1.0)
    idf = jnp.maximum(jnp.log(n_valid / (1.0 + df)), 0.0)
    return words, idf


@functools.partial(jax.jit, static_argnums=(2, 3))
def train_codebook(
    desc: jnp.ndarray,
    valid: jnp.ndarray,
    vocab_size: int = 1024,
    iters: int = 8,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """k-majority clustering of training descriptors.

    Args:
      desc: (N, 8) uint32 training descriptors.
      valid: (N,) bool mask.
      vocab_size: number of words V.
      iters: Lloyd iterations.
    Returns (words (V, 8) uint32, idf (V,) f32) — idf from the training
    corpus word frequencies (tf-idf scoring, as DBoW3's default). Training is
    fully deterministic: maxmin seeding + Lloyd iterations have no random
    component.
    """
    n = desc.shape[0]

    # maxmin (k-means++-style) init: greedily pick the valid descriptor
    # farthest (Hamming) from the already-chosen seeds — random init collapses
    # clusters when seeds double up.
    first = jnp.argmax(valid)  # first valid descriptor

    def pick(carry, _):
        min_d, chosen_any = carry
        idx = jnp.argmax(jnp.where(valid, min_d, -1))
        w = desc[idx]
        d_new = jnp.sum(
            jax.lax.population_count(desc ^ w[None, :]), axis=-1
        ).astype(jnp.int32)
        return (jnp.minimum(min_d, d_new), chosen_any | True), w

    d0 = jnp.sum(
        jax.lax.population_count(desc ^ desc[first][None, :]), axis=-1
    ).astype(jnp.int32)
    (_, _), rest = jax.lax.scan(
        pick, (d0, jnp.asarray(True)), None, length=vocab_size - 1
    )
    words = jnp.concatenate([desc[first][None], rest], axis=0)

    bits = _unpack_bits(desc)  # (N, 256)
    wmask = valid.astype(jnp.float32)

    def step(words, _):
        assign = quantize(desc, words, valid)  # (N,)
        onehot = jax.nn.one_hot(assign, vocab_size, dtype=jnp.float32) * wmask[:, None]
        counts = onehot.sum(axis=0)  # (V,)
        bit_sums = onehot.T @ bits   # (V, 256)
        maj = bit_sums > 0.5 * counts[:, None]
        new_words = _pack_bits(maj)
        # keep empty clusters' previous words
        new_words = jnp.where((counts > 0)[:, None], new_words, words)
        return new_words, counts

    words, counts = jax.lax.scan(lambda w, x: step(w, x), words, None, length=iters)[0], None
    # final assignment for idf
    assign = quantize(desc, words, valid)
    onehot = jax.nn.one_hot(assign, vocab_size, dtype=jnp.float32) * wmask[:, None]
    df = onehot.sum(axis=0)
    n_valid = jnp.maximum(wmask.sum(), 1.0)
    idf = jnp.log(n_valid / (1.0 + df))
    idf = jnp.maximum(idf, 0.0)
    return words, idf
