"""Continuous-query AST (the user-facing query surface).

Covers every SPARQL characteristic the paper's CQuery1 exercises (§4.3):
property paths (len <= 3), CONSTRUCT, UNION, OPTIONAL, hierarchy reasoning
(rdfs:subClassOf via closure sets), and KB access.  Patterns are tagged with
their source: the windowed stream or the background KB.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple, Union


@dataclasses.dataclass(frozen=True)
class Var:
    name: str


@dataclasses.dataclass(frozen=True)
class Const:
    id: int


@dataclasses.dataclass(frozen=True)
class RowId:
    """CONSTRUCT subject that materializes a fresh per-binding row node.

    Used by the decomposer's binding-graph protocol: each result row of a
    sub-query is published as one RDF-graph event keyed by a synthetic node
    (``rdf.ROW_BASE + ns·2^18 + row index``), so the aggregation operator
    joins the published variables of the SAME binding row — never a cross
    product of independently published values.  ``ns`` namespaces the id
    range per operator: two operators publishing the same variable must not
    alias each other's rows.
    """

    ns: int = 0


Term = Union[Var, Const]

STREAM = "stream"
KB = "kb"


@dataclasses.dataclass(frozen=True)
class Pattern:
    s: Term
    p: Term
    o: Term
    src: str = STREAM      # STREAM or KB

    def vars(self) -> Tuple[str, ...]:
        return tuple(t.name for t in (self.s, self.p, self.o) if isinstance(t, Var))


@dataclasses.dataclass(frozen=True)
class PathKB:
    """Property path of fixed length <= 3 through the KB: start -p1/p2/p3-> end."""

    start: Term
    preds: Tuple[int, ...]
    end: Term

    def __post_init__(self):
        assert 1 <= len(self.preds) <= 3, "paper paths have max length 3"


@dataclasses.dataclass(frozen=True)
class PathClosure:
    """Variable-length property path through the KB: ``start p+ end`` /
    ``start p* end``.

    ``min_hops=1`` is SPARQL ``p+`` (one or more edges); ``min_hops=0`` is
    ``p*`` (zero or more).  The zero-length case is reflexive over the nodes
    of the predicate's edge graph plus any constant endpoint of the path
    expression — not over the unbounded universe of terms (SPARQL's ``p*``
    over all graph terms has no bounded-tensor analogue).  The planner
    compiles this through the fused :mod:`repro_torch.kernels.closure` ops into a
    materialized closure-pair relation, never an unrolled join chain.
    """

    start: Term
    pred: int
    end: Term
    min_hops: int = 1       # 1 = p+, 0 = p*

    def __post_init__(self):
        assert self.min_hops in (0, 1), "closure paths are p+ or p*"


@dataclasses.dataclass(frozen=True)
class FilterNum:
    """One FILTER comparison leaf.

    ``value_id >= rdf.NUM_BASE`` is a fixed-point numeric literal and admits
    every ordering operator; a ``value_id`` below the numeric band is an
    IRI/string term id and the comparison is SPARQL *term equality* —
    ``eq``/``ne`` only (the parser enforces this), unbound variables are a
    type error either way.
    """

    var: str
    op: str           # lt | le | gt | ge | eq | ne
    value_id: int     # fixed-point numeric literal id, or an IRI/string id


@dataclasses.dataclass(frozen=True)
class FilterBool:
    """Boolean FILTER combination over numeric comparisons.

    ``op`` is ``and`` / ``or`` (n-ary, >= 2 args) or ``not`` (1 arg); leaves
    are :class:`FilterNum`.  Evaluation follows SPARQL's three-valued logic:
    a comparison on a non-numeric binding is an *error*, errors absorb
    through ``!``/``&&``/``||`` unless a definite ``false`` (for ``&&``) or
    ``true`` (for ``||``) decides the value, and rows whose filter result is
    not definitely true are dropped.
    """

    op: str                                       # and | or | not
    args: Tuple["FilterExpr", ...]

    def __post_init__(self):
        assert self.op in ("and", "or", "not"), self.op
        assert len(self.args) == 1 if self.op == "not" else len(self.args) >= 2

    def vars(self) -> Tuple[str, ...]:
        out: Dict[str, None] = {}

        def walk(e):
            if isinstance(e, FilterNum):
                out.setdefault(e.var, None)
            else:
                for a in e.args:
                    walk(a)

        walk(self)
        return tuple(out)


FilterExpr = Union[FilterNum, FilterBool]


@dataclasses.dataclass(frozen=True)
class FilterSubclass:
    """var rdf:type / rdfs:subClassOf* super_class — hierarchy reasoning."""

    var: str
    type_pred: int
    subclass_pred: int
    super_class: int


@dataclasses.dataclass(frozen=True)
class OptionalGroup:
    patterns: Tuple[Pattern, ...]


@dataclasses.dataclass(frozen=True)
class UnionGroup:
    left: Tuple[Pattern, ...]
    right: Tuple[Pattern, ...]


WhereItem = Union[Pattern, PathKB, PathClosure, FilterNum, FilterBool,
                  FilterSubclass, OptionalGroup, UnionGroup]


@dataclasses.dataclass(frozen=True)
class ConstructTemplate:
    s: Term
    p: Term
    o: Term


@dataclasses.dataclass(frozen=True)
class Query:
    """CONSTRUCT (or SELECT) query over (stream window, KB).

    ``select`` is the projection of the SELECT query form: when non-empty,
    ``construct`` holds the equivalent binding-graph templates (one
    ``(_:row0, ?:var, ?var)`` triple per projected variable — the same
    row-node protocol the decomposer publishes intermediate streams with),
    so every runtime executes SELECT queries unchanged.
    """

    name: str
    where: Tuple[WhereItem, ...]
    construct: Tuple[ConstructTemplate, ...]
    select: Tuple[str, ...] = ()

    def variables(self) -> List[str]:
        # dict-as-ordered-set: membership is O(1), first-seen order preserved
        # (machine-generated queries from the parser can carry thousands of
        # variable occurrences — `name not in list` scans made this O(n²))
        out: Dict[str, None] = {}

        def add(t: Term):
            if isinstance(t, Var):
                out.setdefault(t.name, None)

        for item in self.where:
            if isinstance(item, Pattern):
                for t in (item.s, item.p, item.o):
                    add(t)
            elif isinstance(item, (PathKB, PathClosure)):
                add(item.start)
                add(item.end)
            elif isinstance(item, (FilterNum, FilterSubclass)):
                out.setdefault(item.var, None)
            elif isinstance(item, FilterBool):
                for v in item.vars():
                    out.setdefault(v, None)
            elif isinstance(item, OptionalGroup):
                for p in item.patterns:
                    for t in (p.s, p.p, p.o):
                        add(t)
            elif isinstance(item, UnionGroup):
                for p in item.left + item.right:
                    for t in (p.s, p.p, p.o):
                        add(t)
        for tpl in self.construct:
            for t in (tpl.s, tpl.p, tpl.o):
                add(t)
        return list(out)

    def kb_predicates(self) -> List[int]:
        preds: List[int] = []

        def visit(item):
            if isinstance(item, Pattern) and item.src == KB and isinstance(item.p, Const):
                preds.append(item.p.id)
            elif isinstance(item, PathKB):
                preds.extend(item.preds)
            elif isinstance(item, PathClosure):
                preds.append(item.pred)
            elif isinstance(item, FilterSubclass):
                preds.extend([item.type_pred, item.subclass_pred])
            elif isinstance(item, OptionalGroup):
                for p in item.patterns:
                    visit(p)
            elif isinstance(item, UnionGroup):
                for p in item.left + item.right:
                    visit(p)

        for item in self.where:
            visit(item)
        return sorted(set(preds))
