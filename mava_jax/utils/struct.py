"""Frozen dataclasses that are JAX pytrees.

`@struct.dataclass` makes a frozen dataclass, registers it with
`jax.tree_util.register_dataclass` and gives it a `replace(**updates)` method.
Fields declared with `struct.field(pytree_node=False)` are static: they are
part of the tree's structure (hashed, compared) rather than leaves.
"""

from __future__ import annotations

import dataclasses
from typing import Any, TypeVar

import jax

T = TypeVar("T")


def field(pytree_node: bool = True, **kwargs: Any) -> Any:
    metadata = dict(kwargs.pop("metadata", None) or {}, pytree_node=pytree_node)
    return dataclasses.field(metadata=metadata, **kwargs)


def _replace(self: T, **updates: Any) -> T:
    return dataclasses.replace(self, **updates)


def dataclass(cls: type) -> type:
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    jax.tree_util.register_dataclass(
        cls,
        data_fields=[f.name for f in fields if f.metadata.get("pytree_node", True)],
        meta_fields=[f.name for f in fields if not f.metadata.get("pytree_node", True)],
    )
    cls.replace = _replace
    return cls
