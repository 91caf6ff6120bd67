"""Loop-closure candidate detection with the reference's gating semantics.

Mirrors LoopDetector::obtainCandidates (PlaceRecognition/LoopDetector.cpp:28-84):
- the similarity floor is the MINIMUM BoW score between the query and its
  directly-connected keyframes (LoopDetector.cpp:37-46);
- candidates must not be connected to the query, must beat the floor, and must
  be at least `interval` keyframe ids away (set to 100 by Tracking,
  System/Tracking.cpp:29);
- top `max_candidates` (5) by score (LoopDetector.cpp:78-81).

Array re-design: no inverted file — the BoW database is a dense (K, V) matrix
(see loop/bow.py) and the query scores against every keyframe in one matvec;
the gates become boolean masks.

The codebook trains lazily on descriptors accumulated from the first
`train_after` keyframes (the reference instead ships a pre-trained DBoW3
vocabulary, main.cpp:15; training on the live sequence is self-contained and
dataset-matched).
"""

from __future__ import annotations

from typing import List, Optional, Set, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from rgbdslam.config import LoopConfig
from rgbdslam.loop.bow import bow_scores, bow_vector
from rgbdslam.loop.codebook import train_codebook


class LoopDetector:
    def __init__(self, cfg: LoopConfig = LoopConfig(), max_keyframes: int = 512,
                 train_after: int = 5, seed: int = 0):
        # `seed` kept for API stability; codebook training is deterministic
        self.cfg = cfg
        self.train_after = train_after
        self.words: Optional[jnp.ndarray] = None
        self.idf: Optional[jnp.ndarray] = None
        self.bow_db = np.zeros((max_keyframes, cfg.vocab_size), dtype=np.float32)
        self.count = 0
        self._pending: List[Tuple[np.ndarray, np.ndarray]] = []  # (desc, valid)
        self._connections: List[Set[int]] = []

    # ------------------------------------------------------------------
    @property
    def vocab_width(self) -> int:
        """Single source of truth for every BoW table width: the loaded/
        trained codebook's actual word count, falling back to the configured
        size before one exists. A preloaded vocabulary may differ from
        LoopConfig.vocab_size; all consumers (device bank, host table, blob
        slicing) must size from here."""
        if self.idf is not None:
            return int(self.idf.shape[0])
        return self.cfg.vocab_size

    def load_vocabulary(self, path: str) -> None:
        """Use a pre-trained codebook (the reference's startup vocabulary
        load, main.cpp:32) instead of on-the-fly training."""
        from rgbdslam.loop.vocabulary import load_vocabulary

        self.words, self.idf = load_vocabulary(path)
        if self.bow_db.shape[1] != self.vocab_width:
            # dense BoW tables are sized by the loaded width (vocab_width)
            self.bow_db = np.zeros(
                (self.bow_db.shape[0], self.vocab_width), dtype=np.float32
            )
        # backfill any keyframes registered before the load
        from rgbdslam.loop.bow import bow_vector
        import jax.numpy as jnp

        for k, (d, v) in enumerate(self._pending):
            self.bow_db[k] = np.asarray(
                bow_vector(jnp.asarray(d), jnp.asarray(v), self.words, self.idf)
            )

    def _train(self):
        desc = np.concatenate([d for d, _ in self._pending], axis=0)
        valid = np.concatenate([v for _, v in self._pending], axis=0)
        if desc.dtype == np.uint32:
            train = train_codebook
        else:
            # float descriptor families (SIFT/SURF-class) get an L2 k-means
            # codebook — beyond the reference, whose DBoW3 vocabulary is
            # binary-only (so its SIFT/SURF runs would lose loop closure too)
            from rgbdslam.loop.codebook import train_codebook_float

            train = train_codebook_float
        self.words, self.idf = train(
            jnp.asarray(desc), jnp.asarray(valid),
            self.cfg.vocab_size, self.cfg.vocab_iters,
        )
        # backfill BoW vectors for already-added keyframes
        for k, (d, v) in enumerate(self._pending):
            self.bow_db[k] = np.asarray(
                bow_vector(jnp.asarray(d), jnp.asarray(v), self.words, self.idf)
            )

    def _ensure_capacity(self, k: int) -> None:
        """Double the dense BoW table when full — the inverted-file analog
        grows with the map (PlaceRecognition/LoopDetector.cpp registers every
        keyframe; no cap)."""
        if k >= self.bow_db.shape[0]:
            self.bow_db = np.concatenate(
                [self.bow_db, np.zeros_like(self.bow_db)], axis=0)

    def add(self, desc: np.ndarray, valid: np.ndarray,
            connections: Set[int]) -> int:
        """Register keyframe `count` with its direct connections
        (LoopDetector::add + Frame::mspConnectedKFs)."""
        k = self.count
        self._ensure_capacity(k)
        self._pending.append((np.asarray(desc), np.asarray(valid)))
        self._connections.append(set(connections))
        self.count += 1
        if self.words is None:
            if self.count >= self.train_after:
                self._train()
        else:
            self.bow_db[k] = np.asarray(
                bow_vector(jnp.asarray(desc), jnp.asarray(valid), self.words, self.idf)
            )
        return k

    def add_precomputed(self, vec, connections: Set[int]) -> int:
        """Register keyframe `count` whose BoW vector was already quantized
        on device (the fused keyframe program computes it against the device
        codebook). `vec=None` means the vector stays in the device bank
        (slim-blob mode) — the host row is zero until
        SlamSystem.hydrate_host backfills it; every live scoring path uses
        the device bank or the precomputed `scores` from the fused blob."""
        k = self.count
        self._ensure_capacity(k)
        self._connections.append(set(connections))
        if vec is not None:
            self.bow_db[k] = vec
        self.count += 1
        return k

    def connect(self, a: int, b: int):
        """Record a direct KF connection (Frame::addConnection analog)."""
        if a < self.count and b < self.count:
            self._connections[a].add(b)
            self._connections[b].add(a)

    # ------------------------------------------------------------------
    def candidates(self, k: int,
                   scores: Optional[np.ndarray] = None) -> List[int]:
        """Loop candidates for keyframe k (obtainCandidates semantics).

        `scores` may carry precomputed BoW scores of k against the database
        (>= count entries; the fused keyframe program emits them) — otherwise
        one device matvec computes them here."""
        if self.words is None or self.count < 2:
            return []
        conn = self._connections[k]
        if not conn:
            return []

        if scores is None:
            scores = np.asarray(
                bow_scores(jnp.asarray(self.bow_db[k]),
                           jnp.asarray(self.bow_db[: self.count]))
            )
        else:
            scores = np.asarray(scores)[: self.count]
        conn_idx = [c for c in conn if c != k and c < self.count]
        if not conn_idx:
            return []
        min_score = float(np.min(scores[conn_idx]))  # LoopDetector.cpp:37-46

        ids = np.arange(self.count)
        mask = (
            (scores > min_score)
            & (np.abs(ids - k) > self.cfg.id_interval)
            & (ids != k)
        )
        for c in conn:
            if c < self.count:
                mask[c] = False
        cand = ids[mask]
        if len(cand) == 0:
            return []
        order = np.argsort(-scores[cand])
        return cand[order][: self.cfg.max_candidates].tolist()
