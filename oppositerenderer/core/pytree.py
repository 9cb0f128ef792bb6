"""Frozen dataclasses registered as JAX pytrees.

Every record the renderer passes through ``jit`` (scenes, cameras, hit
records, photon maps) is one of these: array fields are pytree leaves,
fields declared with ``field(static=True)`` are part of the tree
structure (hashed into the jit cache key, never traced).
"""
from __future__ import annotations

import dataclasses

import jax


def field(*, static: bool = False, **kwargs):
    """A dataclass field; ``static=True`` keeps it out of the leaves."""
    return dataclasses.field(metadata={"static": static}, **kwargs)


def _replace(self, **changes):
    """Copy with ``changes`` applied (frozen dataclasses are immutable)."""
    return dataclasses.replace(self, **changes)


def dataclass(cls):
    """Decorate ``cls`` as a frozen dataclass, register it as a pytree and
    give it a ``replace`` method."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    jax.tree_util.register_dataclass(cls)
    cls.replace = _replace
    return cls
