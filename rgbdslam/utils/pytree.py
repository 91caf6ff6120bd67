"""Frozen dataclasses that are JAX pytrees."""

from __future__ import annotations

import dataclasses

import jax


def dataclass(cls):
    """Frozen dataclass whose fields are all pytree leaves, with
    ``.replace(**changes)`` returning an updated copy."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    cls.replace = dataclasses.replace
    return jax.tree_util.register_dataclass(cls)
