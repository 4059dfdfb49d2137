"""Textual C-SPARQL frontend: lexer, recursive-descent parser, serializer.

The paper's interface is a *semantic* continuous query stated in a
C-SPARQL-style text language (CONSTRUCT over stream windows + a background
KB), which the infrastructure decomposes into distributed SCEP operators.
This module makes that text the first-class query surface: ``parse_query``
compiles the subset the paper exercises into the existing
:mod:`repro_torch.core.query` AST via the shared :class:`~repro_torch.core.rdf.Vocab`
term resolver, and ``serialize_query`` emits canonical text such that
``parse_query(serialize_query(q)) == q`` (structural dataclass equality).

Supported subset (§4.3's query characteristics, Tables 1-3):

* ``REGISTER QUERY <name> AS`` prologue (C-SPARQL registration — names the
  continuous query),
* ``PREFIX pfx: <iri>`` declarations (prefixed names are resolved against
  the vocab by their ``pfx:local`` spelling; the IRI documents provenance),
* ``CONSTRUCT { ... }`` templates (vars, constants, ``_:rowN`` row nodes
  for the decomposer's binding-graph protocol) or the ``SELECT ?x ?y``
  query form (projection; lowered onto the same binding-graph protocol —
  one ``(_:row0, ?:var, ?var)`` template per projected variable),
* ``FROM STREAM <...> [RANGE TRIPLES n STEP m]`` / ``FROM <...>`` dataset
  clauses (parsed into :class:`ParseInfo`; with
  ``ExecutionConfig(window_from_query=True)`` the RANGE clause drives the
  registered query's own window geometry, and ``STEP m < n`` is real
  overlap: windows slide by ``m`` triples over slides the aggregator packs
  graph-preservingly — see :mod:`repro_torch.core.window`),
* ``WHERE`` with: stream triple patterns, ``GRAPH <kb> { ... }`` blocks
  (plain KB patterns, fixed-length property paths ``p1/p2/p3`` with
  length <= 3, variable-length closure paths ``p+`` / ``p*`` compiled
  through the fused closure kernel, hierarchy reasoning
  ``type/subClassOf*``), ``OPTIONAL``, ``{...} UNION {...}``, and
  ``FILTER`` with numeric comparisons (negative literals included) and
  ``=`` / ``!=`` term equality on IRI/string ids, combined by ``&&`` /
  ``||`` / ``!`` (SPARQL three-valued semantics).

Term resolution is positional, matching the hand-built query builders:
names in predicate position intern via ``vocab.pred``; subject/object
position via ``vocab.term``; numeric literals via ``Vocab.number`` (the
fixed-point id encoding).  ``<dscep:id:N>`` denotes a raw interned id — the
serializer's escape hatch for ids whose vocab spelling is not a clean
prefixed name (e.g. the decomposer's ``?:var`` binding-protocol predicates),
which keeps serialization total over every AST the planner produces.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Dict, List, Mapping, Optional, Tuple

from . import query as Q
from .rdf import NUM_BASE, NUM_SCALE, Vocab

# default prefix -> IRI table for serialization; unknown prefixes fall back
# to a synthetic urn (resolution only keys off the prefixed-name spelling,
# but emitted declarations should document real provenance where known)
WELL_KNOWN_PREFIXES: Dict[str, str] = {
    "rdf": "http://www.w3.org/1999/02/22-rdf-syntax-ns#",
    "rdfs": "http://www.w3.org/2000/01/rdf-schema#",
    "owl": "http://www.w3.org/2002/07/owl#",
    "xsd": "http://www.w3.org/2001/XMLSchema#",
    "dbo": "http://dbpedia.org/ontology/",
    "dbr": "http://dbpedia.org/resource/",
    "schema": "http://schema.org/",
    "onyx": "http://www.gsi.upm.es/ontologies/onyx/ns#",
}


class SparqlError(ValueError):
    """Parse/serialize failure with source position context."""

    def __init__(self, message: str, line: int = 0, col: int = 0):
        self.line, self.col = line, col
        where = f" (line {line}, column {col})" if line else ""
        super().__init__(message + where)


# --------------------------------------------------------------------------
# lexer
# --------------------------------------------------------------------------

# one colon, word-ish prefix and local part: the spellings Vocab interns
# (``schema:mentions``, ``dbo:MusicalArtist``); anything else round-trips
# through the <dscep:id:N> escape.
PNAME_RE = re.compile(r"^[A-Za-z][A-Za-z0-9_.-]*:[A-Za-z0-9_.-]+$")

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+|\#[^\n]*)
  | (?P<var>\?[A-Za-z_][A-Za-z0-9_]*)
  | (?P<row>_:row[0-9]+)
  | (?P<iri><[^<>\s]*>)
  | (?P<num>-?[0-9]+(?:\.[0-9]+)?)
  | (?P<pname>[A-Za-z][A-Za-z0-9_.-]*:[A-Za-z0-9_.-]+)
  | (?P<nsdecl>[A-Za-z][A-Za-z0-9_.-]*:)
  | (?P<word>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<op><=|>=|!=|=|<|>)
  | (?P<lop>&&|\|\|)
  | (?P<punct>[{}().\[\]/*+!])
    """,
    re.VERBOSE,
)


@dataclasses.dataclass(frozen=True)
class Token:
    kind: str   # var | row | iri | num | pname | nsdecl | word | op | lop | punct | eof
    text: str
    line: int
    col: int


def tokenize(text: str) -> List[Token]:
    toks: List[Token] = []
    pos, line, line_start = 0, 1, 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if m is None:
            raise SparqlError(
                "unexpected character %r" % text[pos],
                line, pos - line_start + 1,
            )
        kind = m.lastgroup
        tok_text = m.group()
        if kind != "ws":
            toks.append(Token(kind, tok_text, line, m.start() - line_start + 1))
        nl = tok_text.count("\n")
        if nl:
            line += nl
            line_start = m.start() + tok_text.rindex("\n") + 1
        pos = m.end()
    toks.append(Token("eof", "<end of query>", line, pos - line_start + 1))
    return toks


# --------------------------------------------------------------------------
# parse result metadata
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ParseInfo:
    """Non-AST query metadata (C-SPARQL registration + dataset clauses)."""

    name: Optional[str] = None              # REGISTER QUERY <name> AS
    prefixes: Tuple[Tuple[str, str], ...] = ()   # (prefix, iri) declarations
    stream_iri: Optional[str] = None        # FROM STREAM <...>
    window_triples: Optional[int] = None    # [RANGE TRIPLES n ...]
    window_step: Optional[int] = None       # [... STEP m]
    kb_iris: Tuple[str, ...] = ()           # FROM <...>


_ID_IRI_RE = re.compile(r"^<dscep:id:([0-9]+)>$")
_CMP_TO_OP = {"<": "lt", "<=": "le", ">": "gt", ">=": "ge", "=": "eq", "!=": "ne"}
_OP_TO_CMP = {v: k for k, v in _CMP_TO_OP.items()}


class _Parser:
    def __init__(self, text: str, vocab: Vocab):
        self.toks = tokenize(text)
        self.i = 0
        self.vocab = vocab
        self.prefixes: Dict[str, str] = {}

    # -- token plumbing ----------------------------------------------------
    def peek(self, ahead: int = 0) -> Token:
        return self.toks[min(self.i + ahead, len(self.toks) - 1)]

    def next(self) -> Token:
        t = self.peek()
        if t.kind != "eof":
            self.i += 1
        return t

    def error(self, message: str, tok: Optional[Token] = None) -> SparqlError:
        tok = tok or self.peek()
        return SparqlError(message, tok.line, tok.col)

    def at_word(self, *words: str) -> bool:
        t = self.peek()
        return t.kind == "word" and t.text.upper() in words

    def expect_word(self, word: str) -> Token:
        if not self.at_word(word):
            raise self.error("expected %r, found %r" % (word, self.peek().text))
        return self.next()

    def expect_punct(self, ch: str) -> Token:
        t = self.peek()
        if t.kind != "punct" or t.text != ch:
            raise self.error("expected %r, found %r" % (ch, t.text))
        return self.next()

    def at_punct(self, ch: str) -> bool:
        t = self.peek()
        return t.kind == "punct" and t.text == ch

    # -- term resolution ---------------------------------------------------
    def _resolve_pname(self, tok: Token, position: str) -> int:
        prefix = tok.text.split(":", 1)[0]
        if prefix not in self.prefixes:
            raise self.error(
                "unknown prefix %r in %r — add a 'PREFIX %s: <...>' "
                "declaration" % (prefix, tok.text, prefix), tok)
        if position == "pred":
            return self.vocab.pred(tok.text)
        return self.vocab.term(tok.text)

    def term(self, position: str) -> Q.Term:
        """One subject/object term: var, pname, number, row node, or id IRI."""
        tok = self.next()
        if tok.kind == "var":
            return Q.Var(tok.text[1:])
        if tok.kind == "pname":
            return Q.Const(self._resolve_pname(tok, position))
        if tok.kind == "num":
            return Q.Const(Vocab.number(float(tok.text)))
        if tok.kind == "row":
            return Q.RowId(ns=int(tok.text[len("_:row"):]))
        if tok.kind == "iri":
            m = _ID_IRI_RE.match(tok.text)
            if m:
                return Q.Const(int(m.group(1)))
            raise self.error(
                "IRI %s is not addressable — use a PREFIXed name or "
                "<dscep:id:N>" % tok.text, tok)
        raise self.error("expected a term, found %r" % tok.text, tok)

    def _pred_segment(self) -> Tuple[int, str]:
        """One path segment: pname or <dscep:id:N>, optionally '*' / '+'."""
        tok = self.next()
        if tok.kind == "pname":
            pid = self._resolve_pname(tok, "pred")
        elif tok.kind == "iri" and _ID_IRI_RE.match(tok.text):
            pid = int(_ID_IRI_RE.match(tok.text).group(1))
        else:
            raise self.error(
                "expected a predicate name, found %r" % tok.text, tok)
        mod = ""
        if self.at_punct("*") or self.at_punct("+"):
            mod = self.next().text
        return pid, mod

    # -- prologue ----------------------------------------------------------
    def parse_prologue(self, info: dict) -> None:
        if self.at_word("REGISTER"):
            self.next()
            self.expect_word("QUERY")
            name_tok = self.next()
            if name_tok.kind not in ("word", "pname"):
                raise self.error("expected a query name after REGISTER QUERY",
                                 name_tok)
            info["name"] = name_tok.text
            self.expect_word("AS")
        while self.at_word("PREFIX"):
            self.next()
            ns = self.next()
            if ns.kind != "nsdecl":
                raise self.error("expected 'prefix:' after PREFIX", ns)
            iri = self.next()
            if iri.kind != "iri":
                raise self.error("expected <iri> in PREFIX declaration", iri)
            self.prefixes[ns.text[:-1]] = iri.text[1:-1]

    def parse_from_clauses(self, info: dict) -> None:
        while self.at_word("FROM"):
            self.next()
            if self.at_word("STREAM"):
                self.next()
                iri = self.next()
                if iri.kind != "iri":
                    raise self.error("expected <stream iri> after FROM STREAM",
                                     iri)
                info["stream_iri"] = iri.text[1:-1]
                if self.at_punct("["):
                    self.next()
                    self.expect_word("RANGE")
                    self.expect_word("TRIPLES")
                    n = self.next()
                    if (n.kind != "num" or "." in n.text or "-" in n.text
                            or int(n.text) < 1):
                        raise self.error(
                            "RANGE TRIPLES takes a positive integer", n)
                    info["window_triples"] = int(n.text)
                    if self.at_word("STEP"):
                        self.next()
                        s = self.next()
                        if (s.kind != "num" or "." in s.text or "-" in s.text
                                or int(s.text) < 1):
                            raise self.error("STEP takes a positive integer", s)
                        info["window_step"] = int(s.text)
                    self.expect_punct("]")
            else:
                iri = self.next()
                if iri.kind != "iri":
                    raise self.error("expected <iri> after FROM", iri)
                info.setdefault("kb_iris", []).append(iri.text[1:-1])

    # -- SELECT ------------------------------------------------------------
    def parse_select(
        self,
    ) -> Tuple[Tuple[str, ...], Tuple[Q.ConstructTemplate, ...]]:
        """``SELECT ?x ?y`` — lowered onto the binding-graph protocol.

        Each projected variable becomes one ``(_:row0, ?:var, ?var)``
        template, so every runtime publishes SELECT rows exactly like the
        decomposer publishes intermediate binding streams (one RDF-graph
        event per result row, keyed by a synthetic row node).
        """
        self.expect_word("SELECT")
        names: List[str] = []
        while self.peek().kind == "var":
            name = self.next().text[1:]
            if name in names:
                raise self.error("duplicate SELECT variable ?%s" % name)
            names.append(name)
        if not names:
            raise self.error("SELECT needs at least one ?variable")
        construct = tuple(
            Q.ConstructTemplate(Q.RowId(0),
                                Q.Const(self.vocab.pred("?:" + v)), Q.Var(v))
            for v in names
        )
        return tuple(names), construct

    # -- CONSTRUCT ---------------------------------------------------------
    def parse_construct(self) -> Tuple[Q.ConstructTemplate, ...]:
        self.expect_word("CONSTRUCT")
        self.expect_punct("{")
        templates: List[Q.ConstructTemplate] = []
        while not self.at_punct("}"):
            s = self.term("term")
            p = self.term("pred")
            o = self.term("term")
            templates.append(Q.ConstructTemplate(s, p, o))
            self.expect_punct(".")
        self.expect_punct("}")
        if not templates:
            raise self.error("CONSTRUCT must emit at least one template")
        return tuple(templates)

    # -- WHERE -------------------------------------------------------------
    def parse_where(self) -> Tuple[Q.WhereItem, ...]:
        self.expect_word("WHERE")
        self.expect_punct("{")
        items: List[Q.WhereItem] = []
        while not self.at_punct("}"):
            if self.at_word("GRAPH"):
                items.extend(self.parse_graph_kb())
            elif self.at_word("OPTIONAL"):
                items.append(self.parse_optional())
            elif self.at_word("FILTER"):
                items.append(self.parse_filter())
            elif self.at_punct("{"):
                items.append(self.parse_union())
            else:
                items.append(self.parse_stream_triple())
        self.expect_punct("}")
        return tuple(items)

    def parse_stream_triple(self, src: str = Q.STREAM) -> Q.Pattern:
        s = self.term("term")
        p = self.term("pred")
        o = self.term("term")
        self.expect_punct(".")
        return Q.Pattern(s, p, o, src)

    def parse_graph_kb(self) -> List[Q.WhereItem]:
        self.expect_word("GRAPH")
        iri = self.next()
        if iri.kind != "iri":
            raise self.error("expected <kb iri> after GRAPH", iri)
        self.expect_punct("{")
        items: List[Q.WhereItem] = []
        while not self.at_punct("}"):
            items.append(self.parse_kb_statement())
        self.expect_punct("}")
        return items

    def parse_kb_statement(self) -> Q.WhereItem:
        subj_tok = self.peek()
        s = self.term("term")
        # a parenthesized or '/'-chained verb is a property path / hierarchy
        # filter; a bare verb is a plain KB pattern
        if self.at_punct("("):
            self.next()
            segs = [self._pred_segment()]
            while self.at_punct("/"):
                self.next()
                segs.append(self._pred_segment())
            self.expect_punct(")")
            return self._finish_path(s, segs, subj_tok, forced_path=True)
        verb_tok = self.peek()
        if verb_tok.kind == "var":
            raise self.error(
                "variable predicates are not supported in GRAPH <kb> "
                "patterns", verb_tok)
        segs = [self._pred_segment()]
        while self.at_punct("/"):
            self.next()
            segs.append(self._pred_segment())
        return self._finish_path(s, segs, subj_tok, forced_path=False)

    def _finish_path(
        self, s: Q.Term, segs: List[Tuple[int, str]], subj_tok: Token,
        forced_path: bool,
    ) -> Q.WhereItem:
        o = self.term("term")
        self.expect_punct(".")
        mods = [mod for _, mod in segs]
        if len(segs) == 1 and mods[0]:
            # variable-length closure path `?x p+ ?y` / `?x p* ?y`
            if isinstance(s, Q.RowId) or isinstance(o, Q.RowId):
                raise self.error("row nodes cannot anchor a property path",
                                 subj_tok)
            return Q.PathClosure(s, segs[0][0], o,
                                 min_hops=0 if mods[0] == "*" else 1)
        if any(mods):
            # multi-segment modifiers: only the paper's hierarchy form
            # `type/subClassOf*` (variable instance, constant super-class)
            if len(segs) != 2 or mods != ["", "*"]:
                raise self.error(
                    "path modifiers are only supported as a single-segment "
                    "closure path '?x p+ ?y' / '?x p* ?y' or the hierarchy "
                    "form '?x type/subClassOf* Class' (exactly two "
                    "segments, star on the second)", subj_tok)
            if not isinstance(s, Q.Var):
                raise self.error(
                    "hierarchy filter subject must be a variable", subj_tok)
            if not isinstance(o, Q.Const):
                raise self.error(
                    "hierarchy filter super-class must be a constant class",
                    subj_tok)
            return Q.FilterSubclass(s.name, segs[0][0], segs[1][0], o.id)
        if len(segs) == 1 and not forced_path:
            return Q.Pattern(s, Q.Const(segs[0][0]), o, Q.KB)
        if len(segs) > 3:
            raise self.error(
                "property path of length %d exceeds the paper's maximum of 3"
                % len(segs), subj_tok)
        if isinstance(s, Q.RowId) or isinstance(o, Q.RowId):
            raise self.error("row nodes cannot anchor a property path",
                             subj_tok)
        return Q.PathKB(s, tuple(pid for pid, _ in segs), o)

    def parse_optional(self) -> Q.OptionalGroup:
        self.expect_word("OPTIONAL")
        self.expect_punct("{")
        pats: List[Q.Pattern] = []
        while not self.at_punct("}"):
            if self.at_word("GRAPH"):
                items = self.parse_graph_kb()
                for it in items:
                    if not isinstance(it, Q.Pattern):
                        raise self.error(
                            "OPTIONAL supports only plain patterns "
                            "(stream or single-predicate KB), not %s"
                            % type(it).__name__)
                    pats.append(it)
            else:
                pats.append(self.parse_stream_triple())
        self.expect_punct("}")
        if not pats:
            raise self.error("OPTIONAL group is empty")
        return Q.OptionalGroup(tuple(pats))

    def parse_union(self) -> Q.UnionGroup:
        left = self._union_branch()
        self.expect_word("UNION")
        right = self._union_branch()
        return Q.UnionGroup(left, right)

    def _union_branch(self) -> Tuple[Q.Pattern, ...]:
        self.expect_punct("{")
        pats: List[Q.Pattern] = []
        while not self.at_punct("}"):
            if self.at_word("GRAPH"):
                for it in self.parse_graph_kb():
                    if not isinstance(it, Q.Pattern):
                        raise self.error(
                            "UNION branches support only plain patterns, "
                            "not %s" % type(it).__name__)
                    pats.append(it)
            else:
                pats.append(self.parse_stream_triple())
        self.expect_punct("}")
        if not pats:
            raise self.error("UNION branch is empty")
        return tuple(pats)

    def parse_filter(self) -> Union[Q.FilterNum, Q.FilterBool]:
        """``FILTER( <bool expr> )`` — ``||`` < ``&&`` < ``!`` precedence.

        Operand lists at one precedence level become one n-ary
        :class:`~repro_torch.core.query.FilterBool` node (``a && b && c`` is a
        single 3-ary ``and``); explicit parentheses nest instead, so every
        tree shape round-trips.  A bare comparison stays a
        :class:`~repro_torch.core.query.FilterNum`.
        """
        self.expect_word("FILTER")
        self.expect_punct("(")
        expr = self._filter_or()
        self.expect_punct(")")
        return expr

    def _filter_or(self) -> Q.FilterExpr:
        parts = [self._filter_and()]
        while self.peek().kind == "lop" and self.peek().text == "||":
            self.next()
            parts.append(self._filter_and())
        return parts[0] if len(parts) == 1 else Q.FilterBool("or", tuple(parts))

    def _filter_and(self) -> Q.FilterExpr:
        parts = [self._filter_unary()]
        while self.peek().kind == "lop" and self.peek().text == "&&":
            self.next()
            parts.append(self._filter_unary())
        return parts[0] if len(parts) == 1 else Q.FilterBool("and", tuple(parts))

    def _filter_unary(self) -> Q.FilterExpr:
        if self.at_punct("!"):
            self.next()
            return Q.FilterBool("not", (self._filter_unary(),))
        if self.at_punct("("):
            self.next()
            expr = self._filter_or()
            self.expect_punct(")")
            return expr
        return self._filter_cmp()

    def _filter_cmp(self) -> Q.FilterNum:
        var_tok = self.next()
        if var_tok.kind != "var":
            raise self.error(
                "FILTER supports numeric comparisons on a variable, e.g. "
                "FILTER(?x >= 1.5)", var_tok)
        cmp_tok = self.next()
        if cmp_tok.kind != "op":
            raise self.error(
                "expected a comparison operator (< <= > >= = !=)", cmp_tok)
        op = _CMP_TO_OP[cmp_tok.text]
        rhs = self.next()
        if rhs.kind == "num":
            return Q.FilterNum(var_tok.text[1:], op,
                               Vocab.number(float(rhs.text)))
        # term equality: `=` / `!=` against an IRI/string id — SPARQL term
        # equality, no numeric-type coercion (and no ordering comparisons)
        if op not in ("eq", "ne"):
            raise self.error(
                "ordering comparisons (< <= > >=) need a numeric literal; "
                "IRIs and strings only support = and !=", rhs)
        if rhs.kind == "pname":
            tid = self._resolve_pname(rhs, "term")
        elif rhs.kind == "iri" and _ID_IRI_RE.match(rhs.text):
            tid = int(_ID_IRI_RE.match(rhs.text).group(1))
        else:
            raise self.error(
                "expected a numeric literal, prefixed name or <dscep:id:N> "
                "in FILTER", rhs)
        return Q.FilterNum(var_tok.text[1:], op, tid)

    # -- top level ---------------------------------------------------------
    def parse(self, default_name: Optional[str]) -> Tuple[Q.Query, ParseInfo]:
        info: dict = {}
        self.parse_prologue(info)
        select: Tuple[str, ...] = ()
        if self.at_word("SELECT"):
            select, construct = self.parse_select()
        else:
            construct = self.parse_construct()
        self.parse_from_clauses(info)
        where = self.parse_where()
        t = self.peek()
        if t.kind != "eof":
            raise self.error("unexpected trailing input %r" % t.text, t)
        name = info.get("name") or default_name or "query"
        q = Q.Query(name=name, where=where, construct=construct,
                    select=select)
        _validate(q, self)
        return q, ParseInfo(
            name=info.get("name"),
            prefixes=tuple(sorted(self.prefixes.items())),
            stream_iri=info.get("stream_iri"),
            window_triples=info.get("window_triples"),
            window_step=info.get("window_step"),
            kb_iris=tuple(info.get("kb_iris", ())),
        )


def _where_variables(q: Q.Query) -> set:
    out = set()
    for item in q.where:
        if isinstance(item, Q.Pattern):
            out |= set(item.vars())
        elif isinstance(item, (Q.PathKB, Q.PathClosure)):
            out |= {t.name for t in (item.start, item.end)
                    if isinstance(t, Q.Var)}
        elif isinstance(item, (Q.FilterNum, Q.FilterSubclass)):
            out.add(item.var)
        elif isinstance(item, Q.FilterBool):
            out |= set(item.vars())
        elif isinstance(item, Q.OptionalGroup):
            for p in item.patterns:
                out |= set(p.vars())
        elif isinstance(item, Q.UnionGroup):
            for p in item.left + item.right:
                out |= set(p.vars())
    return out


def _validate(q: Q.Query, parser: Optional[_Parser] = None) -> None:
    bound = _where_variables(q)
    kind = "SELECT" if q.select else "CONSTRUCT"
    for tpl in q.construct:
        for t in (tpl.s, tpl.p, tpl.o):
            if isinstance(t, Q.Var) and t.name not in bound:
                err = ("%s variable ?%s is not bound by any WHERE "
                       "pattern" % (kind, t.name))
                raise (parser.error(err) if parser else SparqlError(err))


# --------------------------------------------------------------------------
# public API
# --------------------------------------------------------------------------

def parse_query_info(
    text: str, vocab: Vocab, name: Optional[str] = None
) -> Tuple[Q.Query, ParseInfo]:
    """Parse C-SPARQL text into ``(Query AST, ParseInfo metadata)``.

    ``name`` is the fallback query name when the text carries no
    ``REGISTER QUERY <name> AS`` prologue.
    """
    return _Parser(text, vocab).parse(name)


def parse_query(text: str, vocab: Vocab, name: Optional[str] = None) -> Q.Query:
    """Parse C-SPARQL text into the :class:`repro_torch.core.query.Query` AST."""
    return parse_query_info(text, vocab, name)[0]


# --------------------------------------------------------------------------
# serializer (canonical text; parse(serialize(q)) == q)
# --------------------------------------------------------------------------

# decimals implied by the fixed-point scale (rdf.py owns the encoding); the
# formatting must track NUM_SCALE or parse(serialize(q)) == q silently breaks
_NUM_DECIMALS = max(1, int(round(math.log10(NUM_SCALE))))


def _num_text(term_id: int) -> str:
    return "%.*f" % (_NUM_DECIMALS, Vocab.decode_number(term_id))


class _Serializer:
    def __init__(self, vocab: Vocab,
                 prefix_iris: Optional[Mapping[str, str]] = None):
        self.vocab = vocab
        self.prefix_iris = dict(WELL_KNOWN_PREFIXES)
        if prefix_iris:
            self.prefix_iris.update(prefix_iris)
        self.prefixes: Dict[str, None] = {}

    def const(self, term_id: int, position: str) -> str:
        term_id = int(term_id)
        if term_id >= int(NUM_BASE):
            return _num_text(term_id)
        from .rdf import PRED_SPACE
        s = self.vocab.to_str(term_id)
        # a prefixed name only round-trips if re-parsing it in this position
        # re-interns to the same id: predicate position resolves via
        # vocab.pred (ids below PRED_SPACE), term position via vocab.term
        in_band = (term_id < PRED_SPACE) == (position == "pred")
        if in_band and PNAME_RE.match(s):
            self.prefixes.setdefault(s.split(":", 1)[0])
            return s
        return "<dscep:id:%d>" % term_id

    def term(self, t: Q.Term, position: str = "term") -> str:
        if isinstance(t, Q.Var):
            return "?%s" % t.name
        if isinstance(t, Q.RowId):
            return "_:row%d" % t.ns
        return self.const(t.id, position)

    def item(self, item: Q.WhereItem, indent: str) -> str:
        if isinstance(item, Q.Pattern):
            return "%s%s %s %s ." % (
                indent, self.term(item.s), self.term(item.p, "pred"),
                self.term(item.o))
        if isinstance(item, Q.PathKB):
            path = "/".join(self.const(p, "pred") for p in item.preds)
            if len(item.preds) == 1:
                path = "(%s)" % path     # disambiguate from a plain pattern
            return "%s%s %s %s ." % (
                indent, self.term(item.start), path, self.term(item.end))
        if isinstance(item, Q.PathClosure):
            return "%s%s %s%s %s ." % (
                indent, self.term(item.start), self.const(item.pred, "pred"),
                "*" if item.min_hops == 0 else "+", self.term(item.end))
        if isinstance(item, Q.FilterSubclass):
            return "%s?%s %s/%s* %s ." % (
                indent, item.var, self.const(item.type_pred, "pred"),
                self.const(item.subclass_pred, "pred"),
                self.const(item.super_class, "term"))
        raise SparqlError("cannot serialize %r inside a graph block" % item)

    def filter_text(self, e: Q.FilterExpr) -> str:
        """Canonical boolean-filter text; parses back to the same tree.

        Minimal parenthesization under ``|| < && < !`` precedence: nested
        same-op nodes and ``or`` under ``and`` keep explicit parens (the
        parser builds n-ary nodes from each syntactic operand list, so the
        parens are what preserve the nesting); ``!`` always parenthesizes
        its argument.
        """
        if isinstance(e, Q.FilterNum):
            rhs = (_num_text(e.value_id) if e.value_id >= int(NUM_BASE)
                   else self.const(e.value_id, "term"))
            return "?%s %s %s" % (e.var, _OP_TO_CMP[e.op], rhs)
        if e.op == "not":
            return "!(%s)" % self.filter_text(e.args[0])
        sep = " && " if e.op == "and" else " || "
        parts = []
        for a in e.args:
            text = self.filter_text(a)
            if isinstance(a, Q.FilterBool) and a.op != "not" and (
                    a.op == e.op or (e.op == "and" and a.op == "or")):
                text = "(%s)" % text
            parts.append(text)
        return sep.join(parts)

    def serialize(self, q: Q.Query, info: Optional[ParseInfo] = None) -> str:
        body: List[str] = []
        kb_kinds = (Q.PathKB, Q.PathClosure, Q.FilterSubclass)
        i = 0
        where = list(q.where)
        while i < len(where):
            item = where[i]
            is_kb = isinstance(item, kb_kinds) or (
                isinstance(item, Q.Pattern) and item.src == Q.KB)
            if is_kb:
                # consecutive KB items share one GRAPH <kb> block
                block = []
                while i < len(where):
                    it = where[i]
                    if isinstance(it, kb_kinds) or (
                            isinstance(it, Q.Pattern) and it.src == Q.KB):
                        block.append(self.item(it, "    "))
                        i += 1
                    else:
                        break
                body.append("  GRAPH <kb> {")
                body.extend(block)
                body.append("  }")
            elif isinstance(item, Q.Pattern):
                body.append(self.item(item, "  "))
                i += 1
            elif isinstance(item, (Q.FilterNum, Q.FilterBool)):
                body.append("  FILTER(%s)" % self.filter_text(item))
                i += 1
            elif isinstance(item, Q.OptionalGroup):
                body.append("  OPTIONAL {")
                for p in item.patterns:
                    if p.src == Q.KB:
                        body.append("    GRAPH <kb> { %s }"
                                    % self.item(p, "").strip())
                    else:
                        body.append(self.item(p, "    "))
                body.append("  }")
                i += 1
            elif isinstance(item, Q.UnionGroup):
                def branch(pats: Tuple[Q.Pattern, ...]) -> str:
                    parts = []
                    for p in pats:
                        text = self.item(p, "").strip()
                        if p.src == Q.KB:
                            text = "GRAPH <kb> { %s }" % text
                        parts.append(text)
                    return "{ %s }" % " ".join(parts)
                body.append("  %s UNION %s" % (branch(item.left),
                                               branch(item.right)))
                i += 1
            else:
                raise SparqlError("cannot serialize where item %r" % (item,))

        if q.select:
            # SELECT is sugar for the binding-graph templates the parser
            # synthesizes; anything else cannot re-parse to the same AST
            expected = tuple(
                Q.ConstructTemplate(Q.RowId(0),
                                    Q.Const(self.vocab.pred("?:" + v)),
                                    Q.Var(v))
                for v in q.select
            )
            if q.construct != expected:
                raise SparqlError(
                    "SELECT query %r carries construct templates that do "
                    "not match its projection — cannot serialize" % q.name)
            construct = []
        else:
            construct = ["  %s %s %s ." % (self.term(t.s),
                                           self.term(t.p, "pred"),
                                           self.term(t.o))
                         for t in q.construct]
        lines = ["REGISTER QUERY %s AS" % q.name]
        for pfx in sorted(self.prefixes):
            iri = self.prefix_iris.get(pfx, "urn:dscep:%s" % pfx)
            lines.append("PREFIX %s: <%s>" % (pfx, iri))
        if q.select:
            lines.append("SELECT " + " ".join("?%s" % v for v in q.select))
        else:
            lines.append("CONSTRUCT {")
            lines.extend(construct)
            lines.append("}")
        if info is not None:
            if info.stream_iri:
                clause = "FROM STREAM <%s>" % info.stream_iri
                if info.window_triples:
                    clause += " [RANGE TRIPLES %d" % info.window_triples
                    if info.window_step:
                        clause += " STEP %d" % info.window_step
                    clause += "]"
                lines.append(clause)
            for kb_iri in info.kb_iris:
                lines.append("FROM <%s>" % kb_iri)
        lines.append("WHERE {")
        lines.extend(body)
        lines.append("}")
        return "\n".join(lines) + "\n"


def serialize_query(
    q: Q.Query, vocab: Vocab,
    prefix_iris: Optional[Mapping[str, str]] = None,
    info: Optional[ParseInfo] = None,
) -> str:
    """Serialize a Query AST to canonical C-SPARQL text.

    The output always re-parses to a structurally equal AST:
    ``parse_query(serialize_query(q, v), v) == q``.  Constants whose vocab
    spelling is not a clean prefixed name are emitted as ``<dscep:id:N>``.
    ``prefix_iris`` overrides the emitted ``PREFIX`` IRIs (e.g. the
    declarations captured in :class:`ParseInfo`); well-known namespaces
    default to their real IRIs, anything else to ``urn:dscep:<prefix>``.
    ``info`` additionally emits the registration's dataset clauses
    (``FROM STREAM <...> [RANGE TRIPLES n STEP m]`` / ``FROM <...>``), so
    per-query window geometry survives a serialize/parse round trip.
    """
    return _Serializer(vocab, prefix_iris).serialize(q, info)
