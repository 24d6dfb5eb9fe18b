"""Hybrid queries: attribute predicates and selectivity estimation
(paper §3.5; port of repro.core.hybrid).

Attributes are float32 columns aligned to the vector layout. Predicates
support the paper's operators (>, <, >=, <=, =, !=) plus MATCH (a token
bitset test, the FTS5 stand-in) and arbitrary AND/OR trees.
`compile_filter` turns a tree into a callable that maps attrs
[..., n_attr] to a keep mask [...] (the pre-filter plan's row test) and
that carries the tree's `compile_program`: a small postfix program the
scan kernels evaluate on each probed row's attributes inside the scan
(kernels/csrc/pred_program.cuh), so a filtered query builds no mask.

Selectivity estimation (paper §3.5.1, `AttributeStats`): per-column
equi-width histograms and distinct counts, min over AND and the clamped
sum over OR (Eq. 3). It runs on the host in float64 numpy with the JAX
package's very calls, so its estimates -- and every plan decision the
optimizer (core/optimizer.py) takes from them -- equal the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
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
    # filter recovers the structurally-hashable predicate; its program is
    # what the scan kernels evaluate
    fn.predicate = node
    # a tree over the device evaluator's limits carries no program: the
    # scans then take its keep mask, as for an opaque callable
    try:
        fn.program = compile_program(node)
    except ValueError:
        fn.program = None
    _FILTER_CACHE[key] = fn
    return fn


# ---------------------------------------------------------------------------
# The predicate program: what the scan kernels evaluate per row
# ---------------------------------------------------------------------------

# Instruction opcodes (kernels/csrc/pred_program.cuh has the same table):
# leaves compare attrs[col] with a float32 value (match tests uint32 tag
# bits); AND / OR pop `arg` results and push one.
PROGRAM_OPS = {"lt": 0, "le": 1, "gt": 2, "ge": 3, "eq": 4, "ne": 5,
               "match": 6, "and": 7, "or": 8}
# Limits of the device evaluator: the program rides in the launch
# arguments, and its stack of results is one 32-bit register per lane.
MAX_PROGRAM = 64
MAX_DEPTH = 32
# An AND / OR folds its results so far into one whenever this many are on
# the stack, so the depth follows the tree's nesting, not its fan-out (a
# long IN-list, Or of `eq` leaves, stays shallow).
FOLD_EVERY = 8


@dataclasses.dataclass(frozen=True)
class Program:
    """A predicate tree in postfix form. Instruction i is `code[i]` =
    opcode | arg << 8 (arg: the column of a leaf, the operand count of an
    AND / OR) and `word[i]`, the float32 bits of a comparison's value or a
    match's uint32 tag bits. `packed` is the launch argument the kernels
    take: int32 count, then the codes, then the words, MAX_PROGRAM each."""

    code: Tuple[int, ...]
    word: Tuple[int, ...]
    depth: int

    def __len__(self) -> int:
        return len(self.code)

    @property
    def max_col(self) -> int:
        cols = [c >> 8 for c in self.code
                if c & 0xFF < PROGRAM_OPS["and"]]
        return max(cols) if cols else -1

    @property
    def packed(self) -> np.ndarray:
        out = self.__dict__.get("_packed")
        if out is None:
            out = np.zeros((1 + 2 * MAX_PROGRAM,), np.uint32)
            out[0] = len(self.code)
            out[1:1 + len(self.code)] = self.code
            out[1 + MAX_PROGRAM:1 + MAX_PROGRAM + len(self.word)] = self.word
            object.__setattr__(self, "_packed", out)
        return out


_PROGRAM_CACHE: Dict[tuple, Program] = {}


def compile_program(node: Node) -> Program:
    """Predicate tree -> postfix Program (memoised on the frozen tree).
    Comparisons take the value rounded to float32 once, match the low 32
    bits of int(value), as eval_predicate does. Raises ValueError for a
    tree of more than MAX_PROGRAM instructions or a stack deeper than
    MAX_DEPTH (compile_filter then gives the tree no program)."""
    key = _freeze(node)
    prog = _PROGRAM_CACHE.get(key)
    if prog is not None:
        return prog
    code, word = [], []
    depth = 0

    def emit(n: Node, base: int):
        # base: results already on the stack below this subtree
        nonlocal depth
        if isinstance(n, Pred):
            if not 0 <= int(n.col) < 1 << 24:
                raise ValueError(f"predicate column {n.col} out of range")
            code.append(PROGRAM_OPS[n.op] | int(n.col) << 8)
            if n.op == "match":
                word.append(int(n.value) & 0xFFFFFFFF)
            else:
                word.append(int(np.float32(n.value).view(np.uint32)))
            depth = max(depth, base + 1)
            return
        kids = tuple(n.children)
        if not kids:
            raise ValueError("an And / Or node needs at least one child")
        op = PROGRAM_OPS["and" if isinstance(n, And) else "or"]
        held = 0                # this node's results on the stack
        for c in kids:
            if held == FOLD_EVERY:
                code.append(op | held << 8)
                word.append(0)
                held = 1
            emit(c, base + held)
            held += 1
        code.append(op | held << 8)
        word.append(0)

    emit(node, 0)
    if len(code) > MAX_PROGRAM:
        raise ValueError(f"predicate compiles to {len(code)} instructions; "
                         f"the scan kernels take at most MAX_PROGRAM = "
                         f"{MAX_PROGRAM}")
    if depth > MAX_DEPTH:
        raise ValueError(f"predicate needs a stack of {depth}; the scan "
                         f"kernels take at most MAX_DEPTH = {MAX_DEPTH}")
    prog = Program(code=tuple(code), word=tuple(word), depth=depth)
    if len(_PROGRAM_CACHE) >= _FILTER_CACHE_MAX:
        _PROGRAM_CACHE.pop(next(iter(_PROGRAM_CACHE)))
    _PROGRAM_CACHE[key] = prog
    return prog


def _freeze(node: Node):
    if isinstance(node, Pred):
        return (node.col, node.op, node.value)
    tag = "and" if isinstance(node, And) else "or"
    return (tag,) + tuple(_freeze(c) for c in node.children)


# ---------------------------------------------------------------------------
# Histograms & selectivity estimation
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ColumnStats:
    lo: float
    hi: float
    counts: np.ndarray      # [bins]
    n_distinct: int
    n_rows: int
    is_bitset: bool = False  # MATCH columns: per-bit population counts
    bit_counts: Optional[np.ndarray] = None  # [32]

    @property
    def bins(self) -> int:
        return len(self.counts)


class AttributeStats:
    """Per-column equi-width histograms over the live attribute rows
    ([n, n_attr] host array)."""

    def __init__(self, attrs: np.ndarray, bins: int = 64,
                 bitset_cols: Sequence[int] = ()):
        attrs = np.asarray(attrs, np.float64)
        self.n_rows = attrs.shape[0]
        self.cols: Dict[int, ColumnStats] = {}
        for c in range(attrs.shape[1]):
            col = attrs[:, c]
            lo, hi = (float(col.min()), float(col.max())) if len(col) \
                else (0, 1)
            if hi <= lo:
                hi = lo + 1.0
            counts, _ = np.histogram(col, bins=bins, range=(lo, hi))
            bit_counts = None
            if c in bitset_cols:
                u = col.astype(np.uint32)
                bit_counts = np.array(
                    [int(((u >> b) & 1).sum()) for b in range(32)])
            self.cols[c] = ColumnStats(
                lo=lo, hi=hi, counts=counts,
                n_distinct=int(len(np.unique(col))) if len(col) else 1,
                n_rows=self.n_rows,
                is_bitset=c in bitset_cols,
                bit_counts=bit_counts)

    def _leaf_card(self, p: Pred) -> float:
        st = self.cols[p.col]
        n = st.n_rows
        if n == 0:
            return 0.0
        if p.op == "match" and st.is_bitset:
            # independence across tag bits: sel = prod_b (bit_count_b / n)
            # over the required bits
            sel = 1.0
            bits = int(p.value)
            for b in range(32):
                if bits >> b & 1:
                    sel *= st.bit_counts[b] / n
            return sel * n
        if p.op in ("eq", "ne"):
            # skew-aware: the value's histogram bin upper-bounds its count;
            # take the sharper of (uniform 1/n_distinct, bin mass)
            uniform = n / max(1, st.n_distinct)
            card = uniform
            width = (st.hi - st.lo) / st.bins
            if st.lo <= p.value <= st.hi and width > 0:
                bin_i = min(int((p.value - st.lo) / width), st.bins - 1)
                card = min(uniform, float(st.counts[bin_i]))
            return card if p.op == "eq" else n - card
        # range predicates: fractional histogram mass strictly below v
        width = (st.hi - st.lo) / st.bins
        if p.value <= st.lo:
            below = 0.0
        elif p.value >= st.hi:
            below = float(n)
        else:
            bin_i = min(int((p.value - st.lo) / width), st.bins - 1)
            frac = (p.value - (st.lo + bin_i * width)) / width
            below = float(st.counts[:bin_i].sum()
                          + st.counts[bin_i] * np.clip(frac, 0.0, 1.0))
        if p.op in ("lt", "le"):
            return below
        return n - below

    def cardinality(self, node: Node) -> float:
        """|sigma_filters(R)| estimate -- min over AND, sum over OR (Eq. 3)."""
        if isinstance(node, Pred):
            return self._leaf_card(node)
        cards = [self.cardinality(c) for c in node.children]
        if isinstance(node, And):
            return min(cards)
        return min(sum(cards), self.n_rows)

    def selectivity_factor(self, node: Node) -> float:
        """F_hat_filters (Eq. 3): min(card, |R|) / |R|."""
        if self.n_rows == 0:
            return 0.0
        return min(self.cardinality(node), self.n_rows) / self.n_rows
