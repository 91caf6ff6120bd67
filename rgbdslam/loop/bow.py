"""BoW vectors + dense similarity scoring.

Replaces DBoW3's sparse BowVector + inverted-file scoring
(PlaceRecognition/LoopDetector.cpp:22-26, Core/Frame.cpp:243-249): with a flat
V-word codebook, every keyframe's BoW vector is a dense (V,) tf-idf histogram
and scoring a query against ALL keyframes is a single (K, V) x (V,) matvec —
the inverted file disappears into dense linear algebra, which on a GPU is both
simpler and faster than list-walking for any realistic K.

Score: DBoW3 L1 norm: s(v, w) = 1 - 0.5 * |v/|v|_1 - w/|w|_1|_1, in [0, 1].
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from rgbdslam.loop.codebook import quantize


@jax.jit
def bow_vector(
    desc: jnp.ndarray,
    valid: jnp.ndarray,
    words: jnp.ndarray,
    idf: jnp.ndarray,
) -> jnp.ndarray:
    """tf-idf BoW vector (V,), L1-normalized."""
    v = words.shape[0]
    assign = quantize(desc, words, valid)
    onehot = jax.nn.one_hot(assign, v, dtype=jnp.float32) * valid[:, None]
    tf = onehot.sum(axis=0)
    vec = tf * idf
    norm = jnp.sum(jnp.abs(vec))
    return vec / jnp.maximum(norm, 1e-12)


@jax.jit
def bow_scores(query: jnp.ndarray, database: jnp.ndarray) -> jnp.ndarray:
    """L1 similarity of one query (V,) against a database (K, V) -> (K,).

    Both inputs must already be L1-normalized (bow_vector output).
    """
    l1 = jnp.sum(jnp.abs(query[None, :] - database), axis=-1)
    return 1.0 - 0.5 * l1
