"""Query language for the Scientific Discovery Service (§III-B5).

The paper's command-line utility accepts query strings with ``=``, ``>`` and
``<`` operators (plus ``like`` for text).  We implement that surface, extended
with ``>=``, ``<=``, ``!=`` and ``and`` conjunctions, compiled to
parameterized SQL over the discovery-shard schema:

    attributes(path, attr_name, attr_type, value_int, value_real, value_text)

Examples accepted::

    location = "Pacific Ocean"
    day_or_night = 1
    date like "2014-07-%"
    instrument = MODIS and hour >= 12

Each predicate matches rows of one attribute; conjunctions intersect the
*file sets* (a file satisfies the query when every predicate matches at least
one of its attribute rows — the many-to-many association the paper keeps a
relational store for).

Summary-pruning protocol
------------------------
Each discovery shard maintains a :class:`ShardSummary` — a bloom-style bitset
over the *terms* its index could answer for:

* ``a:<name>`` — some row carries attribute ``<name>``;
* ``e:<name>:t:<text>`` / ``e:<name>:n:<num>`` — some row has exactly that
  value (numerics normalized so ``5`` and ``5.0`` share a term, mirroring the
  cross-typed SQL match in :meth:`Predicate.to_sql`);
* ``p:<prefix>`` — some indexed path lives under ``<prefix>``.

Bits are only ever set (deletes never clear them), so a summary can go stale
in exactly one direction: **false positives only** — a shard may be contacted
needlessly, never skipped wrongly.  :meth:`Predicate.summary_requirements`
compiles a predicate to CNF over terms (every group must have at least one
term present for the shard to possibly match); equality predicates also
require their value term, while range/like predicates only require attribute
presence.  :meth:`ScatterGatherPlan.prune` evaluates those requirements
against whatever fresh summaries the caller holds and returns a
:class:`PruneDecision`: per-shard predicate subsets to push down, shards with
no candidate predicate dropped from the fan-out entirely, and ``empty=True``
when some predicate has *zero* candidate shards — the query answers ``[]``
with no RPC at all.  Shards without a fresh summary always receive every
predicate, so pruning degrades to the full fan-out, never past it.

Summaries travel on existing wires: every ``scatter_query`` reply piggybacks
the shard's current summary (epoch-stamped), and summaries replicate between
DTNs through the ordinary replication log — no new RPC is introduced.
"""

from __future__ import annotations

import hashlib
import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

__all__ = [
    "Predicate",
    "Query",
    "parse_query",
    "QueryError",
    "ScatterGatherPlan",
    "plan_query",
    "ShardSummary",
    "PruneDecision",
    "SUMMARY_BITS",
    "SUMMARY_HASHES",
]

#: Default summary width. 4096 bits = 512 B on the wire — two orders of
#: magnitude under one attribute-row replication record per 100 files, yet
#: large enough that a testbed-sized shard (≤ a few thousand terms) stays far
#: from saturation.
SUMMARY_BITS = 4096

#: Hash functions per term (k).  With n/m ratios this testbed produces, k=3
#: keeps the false-positive rate under a few percent.
SUMMARY_HASHES = 3


class QueryError(ValueError):
    pass


_OPS = ("<=", ">=", "!=", "=", "<", ">", "like")

_TOKEN = re.compile(
    r"""\s*(?:
        (?P<quoted>"[^"]*"|'[^']*') |
        (?P<op><=|>=|!=|=|<|>) |
        (?P<word>[^\s<>=!]+)
    )""",
    re.VERBOSE,
)


def _tokenize(text: str) -> List[str]:
    tokens, pos = [], 0
    while pos < len(text):
        m = _TOKEN.match(text, pos)
        if not m or m.end() == pos:
            if text[pos:].strip():
                raise QueryError(f"cannot tokenize query near: {text[pos:]!r}")
            break
        pos = m.end()
        if m.group("quoted") is not None:
            tokens.append(("value", m.group("quoted")[1:-1]))
        elif m.group("op") is not None:
            tokens.append(("op", m.group("op")))
        else:
            word = m.group("word")
            if word.lower() == "and":
                tokens.append(("and", word))
            elif word.lower() == "like":
                tokens.append(("op", "like"))
            else:
                tokens.append(("word", word))
    return tokens


def _coerce(raw: str) -> Tuple[str, Union[int, float, str]]:
    """Literal → (attr_type, value), following the paper's 3 datatypes."""
    try:
        return "int", int(raw)
    except ValueError:
        pass
    try:
        return "float", float(raw)
    except ValueError:
        pass
    return "text", raw


def _num_norm(value: Union[int, float]) -> str:
    """Normalize a numeric so int/float representations share one term.

    Mirrors the cross-typed column match in :meth:`Predicate.to_sql`: a
    predicate ``hour = 12`` must hit rows stored as ``12`` *and* ``12.0``.
    """
    if isinstance(value, float) and value.is_integer():
        return repr(int(value))
    return repr(value)


def summary_terms_for_row(
    attr_name: str,
    attr_type: str,
    value_int: Optional[int],
    value_real: Optional[float],
    value_text: Optional[str],
) -> List[str]:
    """The terms one attribute row contributes to its shard's summary."""
    terms = [f"a:{attr_name}"]
    if attr_type == "text" and value_text is not None:
        terms.append(f"e:{attr_name}:t:{value_text}")
    elif value_int is not None:
        terms.append(f"e:{attr_name}:n:{_num_norm(value_int)}")
    elif value_real is not None:
        terms.append(f"e:{attr_name}:n:{_num_norm(value_real)}")
    return terms


def path_prefix_terms(path: str) -> List[str]:
    """``p:`` terms for every ancestor prefix of ``path`` (including "/")."""
    terms = ["p:/"]
    parts = [p for p in path.split("/") if p]
    prefix = ""
    for part in parts[:-1]:
        prefix += "/" + part
        terms.append(f"p:{prefix}")
    return terms


class ShardSummary:
    """Bloom-style bitset over one discovery shard's indexed terms.

    Sticky by construction — :meth:`add` only sets bits, so membership answers
    are one-sided: ``might_contain`` returning ``False`` is a proof of
    absence *as of the summary's epoch*; ``True`` proves nothing.  ``version``
    counts bit flips (not adds), which is what the discovery service's
    dirty-tracking uses to decide when a summary is worth re-replicating.
    """

    __slots__ = ("nbits", "_bits", "version")

    def __init__(self, nbits: int = SUMMARY_BITS, bits: Optional[bytes] = None):
        if nbits <= 0 or nbits % 8:
            raise QueryError(f"summary nbits must be a positive multiple of 8, got {nbits}")
        self.nbits = nbits
        self._bits = bytearray(bits) if bits is not None else bytearray(nbits // 8)
        if len(self._bits) != nbits // 8:
            raise QueryError(f"summary bit buffer is {len(self._bits)}B, want {nbits // 8}B")
        self.version = 0

    def _positions(self, term: str) -> List[int]:
        digest = hashlib.blake2b(term.encode("utf-8"), digest_size=4 * SUMMARY_HASHES).digest()
        return [
            int.from_bytes(digest[i : i + 4], "little") % self.nbits
            for i in range(0, 4 * SUMMARY_HASHES, 4)
        ]

    def add(self, term: str) -> bool:
        """Set the term's bits; return True if any bit actually flipped."""
        flipped = False
        for p in self._positions(term):
            mask = 1 << (p & 7)
            if not self._bits[p >> 3] & mask:
                self._bits[p >> 3] |= mask
                flipped = True
        if flipped:
            self.version += 1
        return flipped

    def might_contain(self, term: str) -> bool:
        return all(self._bits[p >> 3] & (1 << (p & 7)) for p in self._positions(term))

    def add_row(
        self,
        attr_name: str,
        attr_type: str,
        value_int: Optional[int],
        value_real: Optional[float],
        value_text: Optional[str],
    ) -> None:
        for term in summary_terms_for_row(attr_name, attr_type, value_int, value_real, value_text):
            self.add(term)

    def add_path(self, path: str) -> None:
        for term in path_prefix_terms(path):
            self.add(term)

    def might_match(self, pred: "Predicate") -> bool:
        """Could this shard hold a row satisfying ``pred``? (one-sided)"""
        return all(
            any(self.might_contain(term) for term in group)
            for group in pred.summary_requirements()
        )

    def saturation(self) -> float:
        """Fraction of bits set — a load signal, not a correctness one."""
        return sum(bin(b).count("1") for b in self._bits) / self.nbits

    def merge(self, other: "ShardSummary") -> None:
        """Bitwise OR ``other`` in (both sides must agree on width)."""
        if other.nbits != self.nbits:
            raise QueryError(f"cannot merge {other.nbits}-bit summary into {self.nbits}-bit")
        for i, b in enumerate(other._bits):
            self._bits[i] |= b
        self.version += 1

    def to_message(self) -> Dict[str, Any]:
        return {"nbits": self.nbits, "bits": bytes(self._bits)}

    @classmethod
    def from_message(cls, msg: Mapping[str, Any]) -> "ShardSummary":
        return cls(nbits=int(msg["nbits"]), bits=bytes(msg["bits"]))


@dataclass(frozen=True)
class Predicate:
    attr: str
    op: str
    value: Union[int, float, str]
    attr_type: str

    def to_sql(self) -> Tuple[str, Sequence[Any]]:
        """SQL selecting *paths* whose attribute rows satisfy this predicate."""
        col = {"int": "value_int", "float": "value_real", "text": "value_text"}[self.attr_type]
        if self.op == "like":
            if self.attr_type != "text":
                raise QueryError("'like' only applies to text attributes")
            cond = f"{col} LIKE ?"
            params: Tuple[Any, ...] = (self.value,)
        elif self.op == "!=":
            cond = f"{col} <> ?"
            params = (self.value,)
        else:
            cond = f"{col} {self.op} ?"
            params = (self.value,)
        # int predicates also match float-typed rows and vice versa
        if self.attr_type in ("int", "float"):
            other = "value_real" if col == "value_int" else "value_int"
            op = "<>" if self.op == "!=" else ("LIKE" if self.op == "like" else self.op)
            cond = f"({cond} OR {other} {op} ?)"
            params = params + (self.value,)
        sql = f"SELECT DISTINCT path FROM attributes WHERE attr_name = ? AND {cond}"
        return sql, (self.attr,) + tuple(params)

    def summary_requirements(self) -> List[List[str]]:
        """CNF over summary terms a shard must pass to possibly match.

        Every predicate requires the attribute-presence term; equality
        predicates additionally require the exact value term.  Range and
        ``like`` predicates cannot be narrowed beyond attribute presence —
        the summary stores point terms, not order.
        """
        groups = [[f"a:{self.attr}"]]
        if self.op == "=":
            if self.attr_type == "text":
                groups.append([f"e:{self.attr}:t:{self.value}"])
            else:
                groups.append([f"e:{self.attr}:n:{_num_norm(self.value)}"])
        return groups


@dataclass(frozen=True)
class Query:
    predicates: Tuple[Predicate, ...]

    def to_sql(self) -> Tuple[str, Sequence[Any]]:
        """Intersection of per-predicate path sets (AND semantics)."""
        if not self.predicates:
            raise QueryError("empty query")
        parts, params = [], []
        for pred in self.predicates:
            sql, p = pred.to_sql()
            parts.append(sql)
            params.extend(p)
        return " INTERSECT ".join(parts), tuple(params)


@dataclass(frozen=True)
class ScatterGatherPlan:
    """Distributed execution plan for one query over N discovery shards.

    The sequential strategy this replaces ran the *whole conjunction* on each
    shard and unioned the results — wrong whenever one file's attribute rows
    are split across shards (a manual ``tag`` lands on the DTN owning the
    path's global hash, while LW-offline extraction lands on a DTN chosen by
    the hash over the home DC's DTNs), and serial in the number of shards.

    The plan instead **pushes each predicate down** to every shard (all
    predicates for one shard ride a single batched RPC) and **merges
    centrally**: per predicate, union the per-shard path sets; then intersect
    across predicates.  Set algebra makes the two-level merge exact:
    ``∩_p (∪_s match(s, p))`` is the true global answer because a path
    matches a predicate iff some shard holds a matching row for it.
    """

    query: Query

    def predicate_messages(self) -> List[dict]:
        """Codec-safe predicate descriptions for pushdown to each shard."""
        return [
            {"attr": p.attr, "op": p.op, "value": p.value, "attr_type": p.attr_type}
            for p in self.query.predicates
        ]

    def shard_calls(self) -> List[Tuple[str, dict]]:
        """The per-shard batched call list (one ``query_predicate`` per predicate)."""
        return [("query_predicate", kw) for kw in self.predicate_messages()]

    def merge(
        self,
        per_shard_results: Sequence[Sequence[Sequence[str]]],
        *,
        group_size: int = 8,
    ) -> List[str]:
        """Central merge: union over shards per predicate, intersect predicates.

        ``per_shard_results[s][p]`` is shard *s*'s path list for predicate *p*.

        The per-predicate union runs as a **tree-merge in fixed-size
        groups**: shard results fold ``group_size`` at a time, level by
        level, instead of one flat N-way union.  Union is associative so the
        answer is identical; what changes is the merge topology — no single
        fold ever touches more than ``group_size`` partial sets, which is
        what lets the planner's merge step distribute (and stay cache-sized)
        past the testbed's 8 DTNs (benchmarked at 16/32 in fig9d).
        """
        if group_size < 2:
            raise QueryError("merge group_size must be >= 2")
        matched: set = set()
        for p_idx in range(len(self.query.predicates)):
            partials: List[set] = [set(sr[p_idx]) for sr in per_shard_results]
            while len(partials) > 1:
                partials = [
                    set().union(*partials[i : i + group_size])
                    for i in range(0, len(partials), group_size)
                ]
            union = partials[0] if partials else set()
            matched = union if p_idx == 0 else (matched & union)
            if not matched:
                return []
        return sorted(matched)

    def prune(
        self,
        summaries: Mapping[int, "ShardSummary"],
        n_shards: int,
    ) -> "PruneDecision":
        """Decide which (shard, predicate) pairs must actually be contacted.

        ``summaries`` holds whatever *fresh* summaries the caller has — a
        shard with no entry is assumed to possibly match everything (full
        pushdown), so missing/stale summaries degrade pruning to the plain
        fan-out rather than risking a wrong skip.  If any predicate ends up
        with zero candidate shards the whole conjunction is empty
        (``∩`` over an empty ``∪``) and ``send`` comes back empty with
        ``empty=True``.
        """
        preds = self.query.predicates
        send: Dict[int, List[int]] = {}
        pruned_pairs = 0
        candidates = [0] * len(preds)
        for shard in range(n_shards):
            summary = summaries.get(shard)
            if summary is None:
                send[shard] = list(range(len(preds)))
                for i in range(len(preds)):
                    candidates[i] += 1
                continue
            keep: List[int] = []
            for i, pred in enumerate(preds):
                if summary.might_match(pred):
                    keep.append(i)
                    candidates[i] += 1
                else:
                    pruned_pairs += 1
            if keep:
                send[shard] = keep
        empty = any(c == 0 for c in candidates)
        if empty:
            send = {}
        return PruneDecision(
            send=send,
            n_shards=n_shards,
            pruned_shards=n_shards - len(send),
            pruned_pairs=pruned_pairs,
            empty=empty,
        )


@dataclass(frozen=True)
class PruneDecision:
    """Outcome of :meth:`ScatterGatherPlan.prune` for one query.

    ``send`` maps shard index → the *global* predicate indices to push down
    there; shards absent from ``send`` are skipped entirely.  ``empty`` means
    some predicate had zero candidate shards, so the conjunction is provably
    empty and no shard needs contacting at all.
    """

    send: Dict[int, List[int]]
    n_shards: int
    pruned_shards: int
    pruned_pairs: int
    empty: bool

    def contacted(self) -> int:
        return len(self.send)


def plan_query(text: str) -> ScatterGatherPlan:
    """Parse + plan a query for scatter-gather execution (raises QueryError)."""
    return ScatterGatherPlan(parse_query(text))


def parse_query(text: str) -> Query:
    tokens = _tokenize(text)
    preds: List[Predicate] = []
    i = 0
    while i < len(tokens):
        kind, val = tokens[i]
        if kind == "and":
            i += 1
            continue
        if kind not in ("word", "value"):
            raise QueryError(f"expected attribute name, got {val!r}")
        attr = val
        if i + 2 >= len(tokens) + 1 and i + 1 >= len(tokens):
            raise QueryError(f"dangling attribute {attr!r}")
        kind_op, op = tokens[i + 1]
        if kind_op != "op" or op not in _OPS:
            raise QueryError(f"expected operator after {attr!r}, got {op!r}")
        if i + 2 >= len(tokens):
            raise QueryError(f"missing value for {attr!r} {op}")
        kind_v, raw = tokens[i + 2]
        if kind_v == "value":  # quoted ⇒ always text
            attr_type, value = "text", raw
        else:
            attr_type, value = _coerce(raw)
        preds.append(Predicate(attr=attr, op=op, value=value, attr_type=attr_type))
        i += 3
    if not preds:
        raise QueryError(f"no predicates in query: {text!r}")
    return Query(tuple(preds))
