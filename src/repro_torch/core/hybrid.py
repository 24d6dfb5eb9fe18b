"""Attribute predicates (port of the predicate half of repro.core.hybrid).

Attributes are float32 columns aligned to the vector layout. Predicates
support the paper's operators (>, <, >=, <=, =, !=) plus MATCH (a token
bitset test, the FTS5 stand-in) and arbitrary AND/OR trees. In this port
a predicate runs as a post-filter: `compile_filter` turns a tree into a
callable that maps attrs [..., n_attr] to a keep mask [...], which the
scan kernels read beside `valid`. Selectivity estimation (AttributeStats)
belongs to the optimizer and is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple, Union

import torch

_OPS = ("lt", "le", "gt", "ge", "eq", "ne", "match")
# symbolic spellings accepted by QuerySpec.where; canonicalised at
# construction so structurally-equal predicates stay hash-equal
_OP_ALIASES = {"<": "lt", "<=": "le", ">": "gt", ">=": "ge",
               "==": "eq", "=": "eq", "!=": "ne"}


@dataclasses.dataclass(frozen=True)
class Pred:
    """Leaf predicate: attrs[..., col] <op> value.

    `match` treats the column as a token bitset (each row holds an int
    bitmask of tags; value is the required tag bitmask)."""
    col: int
    op: str
    value: float

    def __post_init__(self):
        op = _OP_ALIASES.get(self.op, self.op)
        if op != self.op:
            object.__setattr__(self, "op", op)
        if self.op not in _OPS:
            raise ValueError(f"unknown predicate op {self.op!r}")


@dataclasses.dataclass(frozen=True)
class And:
    children: Tuple["Node", ...]


@dataclasses.dataclass(frozen=True)
class Or:
    children: Tuple["Node", ...]


Node = Union[Pred, And, Or]


def _leaf_mask(p: Pred, attrs: torch.Tensor) -> torch.Tensor:
    col = attrs[..., p.col]
    v = p.value
    if p.op == "lt":
        return col < v
    if p.op == "le":
        return col <= v
    if p.op == "gt":
        return col > v
    if p.op == "ge":
        return col >= v
    if p.op == "eq":
        return col == v
    if p.op == "ne":
        return col != v
    # match: all tag bits of v present in the row bitset (uint32 values,
    # held in int64 so the bitwise ops exist on every device)
    bits = int(v) & 0xFFFFFFFF
    return (col.to(torch.int64) & bits) == bits


def eval_predicate(node: Node, attrs: torch.Tensor) -> torch.Tensor:
    """[..., n_attr] -> [...] bool."""
    if isinstance(node, Pred):
        return _leaf_mask(node, attrs)
    masks = [eval_predicate(c, attrs) for c in node.children]
    out = masks[0]
    for m in masks[1:]:
        out = (out & m) if isinstance(node, And) else (out | m)
    return out


# Compiled predicates are memoised on the frozen tree so the same tree
# always yields the same callable object; FIFO-bounded so ad-hoc one-off
# predicates from a long-lived service cannot grow memory forever.
_FILTER_CACHE: Dict[tuple, object] = {}
_FILTER_CACHE_MAX = 1024


def compile_filter(node: Node):
    """Predicate tree -> hashable callable attrs -> keep mask."""
    key = _freeze(node)
    cached = _FILTER_CACHE.get(key)
    if cached is not None:
        return cached
    if len(_FILTER_CACHE) >= _FILTER_CACHE_MAX:
        _FILTER_CACHE.pop(next(iter(_FILTER_CACHE)))

    def fn(attrs: torch.Tensor) -> torch.Tensor:
        return eval_predicate(node, attrs)
    fn.__name__ = f"filter_{hash(key) & 0xFFFFFFFF:x}"
    # the source tree rides along so a QuerySpec built from a compiled
    # filter recovers the structurally-hashable predicate
    fn.predicate = node
    _FILTER_CACHE[key] = fn
    return fn


def _freeze(node: Node):
    if isinstance(node, Pred):
        return (node.col, node.op, node.value)
    tag = "and" if isinstance(node, And) else "or"
    return (tag,) + tuple(_freeze(c) for c in node.children)
