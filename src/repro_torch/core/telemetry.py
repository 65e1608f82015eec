"""Telemetry plane: unified metrics registry + cross-DC distributed tracing.

SCISPACE's evaluation hinges on explaining *where* cross-DC time goes —
metadata export vs native access vs query scatter (§IV).  This module is the
cross-cutting layer the rest of the stack reports through:

- a **metrics registry** of typed :class:`Counter` / :class:`Gauge` /
  :class:`Histogram` instruments with hierarchical dotted names
  (``rpc.retries``, ``datapath.cache.hit_bytes``, ``lease.fenced``).  One
  registry lives on every DTN (:class:`~repro_torch.core.cluster.DTN`) and one on
  every client plane (:class:`~repro_torch.core.plane.ServicePlane`); existing
  subsystem ``stats()`` dicts are folded in lazily at scrape time via
  :meth:`MetricsRegistry.add_collector`, and
  ``Collaboration.observe()`` / ``Workspace.telemetry()`` fold all of them
  into one flat scrape with :func:`fold_snapshots`;
- **distributed tracing** — :class:`Tracer` mints trace/span IDs at every
  Workspace entry point; the RPC envelope carries ``trace=[tid, sid]``
  alongside epochs and idempotency rids, so every hop (retried calls,
  breaker probes, fenced rejections, lease grant fan-outs, quorum pushes,
  replication pump ships, striped datapath lanes) records a child
  :class:`Span` with parent links, modeled wire time, and a status in
  ``{ok, retried, fenced, degraded, unavailable, error}``.  Spans land in a
  bounded per-node :class:`SpanBuffer`;
  ``Collaboration.collect_trace(trace_id)`` reassembles the cross-DC tree;
- **timeline profiling** — spans are stamped on a shared session clock
  (:func:`now`), so :func:`render_timeline` prints a per-op text timeline and
  :func:`chrome_trace` exports Chrome-trace JSON (``chrome://tracing`` /
  Perfetto) for real tooling.

Paper figures -> the metrics that explain them
----------------------------------------------

==========  ================================================================
figure      telemetry that explains the result
==========  ================================================================
fig7        ``datapath.transfer_seconds`` histogram vs block size;
            ``rpc.wire_seconds`` (per-op channel cost the LW amortizes)
fig9d       ``rpc.calls`` vs ``rpc.ops`` (batching ratio the metadata plane
            exists to improve); ``rpc.call_seconds`` p50/p99
fig10       ``replication.records_shipped`` / ``plane.replica_hits`` (reads
            served at the home DC instead of crossing the WAN)
fig11       ``rpc.pack_seconds`` (codec fast path),
            ``replication.records_compacted`` (path-compacted shipping),
            ``plane.shards_pruned`` (summary-pruned scatter)
fig12       ``datapath.cache.hit_bytes`` vs ``miss_bytes``;
            ``datapath.prefetch_*``; read-ahead *overlap* is visible as
            concurrent ``data.prefetch`` root spans in the trace buffer
fig13       ``rpc.retries`` / ``rpc.deduped`` (exactly-once under chaos),
            ``faults.*`` (injected drops/dups), ``plane.degraded_reads``
fig14       ``lease.granted`` / ``lease.fenced`` (fence floor refusals),
            ``plane.degraded_writes`` / ``plane.quorum_acks``; the full
            story of one degraded write is its assembled trace tree
fig15       the overhead of *this* layer: tracing-on vs tracing-off on the
            fig9d pipelined-write burst, gated <= 5%
==========  ================================================================

Design notes: spans are ``__slots__`` objects appended to a ``deque``, and
IDs are integers — ``(site_number << 40) | counter``, so they are unique
process-wide, cheap to mint, and cheap on the wire (two fixed-width ints in
the RPC envelope instead of strings) — the hot path (one client span + one
server span per RPC) costs a few microseconds so tracing can stay on by
default.  A root span's ``span_id`` doubles as its ``trace_id``.  ``trace_enabled=False`` short-circuits before any allocation.
The registry never *pushes* subsystem counters; collectors pull the
existing ``stats()`` dicts at scrape time, so there is exactly one source
of truth per counter and the hand-merged ``resilience_stats()`` drift
hazard goes away.
"""

from __future__ import annotations

import itertools
import math
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "TRACE_ENABLED",
    "TRACE_BUFFER_SPANS",
    "HIST_BUCKETS",
    "now",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "fold_snapshots",
    "Span",
    "SpanBuffer",
    "Tracer",
    "Telemetry",
    "assemble_trace",
    "render_timeline",
    "chrome_trace",
]

#: defaults for the ``trace_enabled`` / ``trace_buffer_spans`` /
#: ``hist_buckets`` knobs (see configs/scispace_testbed.py)
TRACE_ENABLED = True
TRACE_BUFFER_SPANS = 4096
HIST_BUCKETS = 48

_EPOCH = time.perf_counter()

#: one number per Tracer instance — the high bits of every id it mints
_SITE_IDS = itertools.count(1)


def now() -> float:
    """Seconds on the shared session clock.

    ``perf_counter`` rebased to module import, so spans recorded by every
    plane, DTN, and worker thread in one process line up on one axis.
    """
    return time.perf_counter() - _EPOCH


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------


class Counter:
    """Monotonic count.  ``inc`` is GIL-atomic enough for CPython ints, but
    takes the lock anyway so torn reads can't surface in scrapes."""

    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self.value += n

    def snapshot(self) -> int:
        return self.value


class Gauge:
    """Point-in-time value (set, not accumulated)."""

    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self.value = v

    def snapshot(self) -> float:
        return self.value


class Histogram:
    """Fixed log-scale (power-of-two) bucket histogram for latencies/bytes.

    Bucket ``i`` holds observations in ``(scale * 2**(i-1), scale * 2**i]``;
    ``scale`` is the finest resolution (default 100 ns for latencies — pass
    ``scale=1.0`` for byte sizes).  Bucketing is one :func:`math.frexp`, so
    observing is cheap enough for per-RPC use.  Percentiles come from the
    bucket upper bound clamped to the observed min/max — coarse (factor-of-2)
    but monotone and mergeable across registries.
    """

    __slots__ = ("name", "scale", "n", "counts", "count", "total", "vmin", "vmax", "_lock")

    def __init__(self, name: str, *, scale: float = 1e-7, buckets: int = HIST_BUCKETS):
        self.name = name
        self.scale = float(scale)
        self.n = max(4, int(buckets))
        self.counts = [0] * self.n
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = 0.0
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        if v < 0.0:
            v = 0.0
        if v > 0.0:
            idx = math.frexp(v / self.scale)[1]  # ceil(log2) + 1 for the (.., 2^i] edge
            if idx < 0:
                idx = 0
            elif idx >= self.n:
                idx = self.n - 1
        else:
            idx = 0
        with self._lock:
            self.counts[idx] += 1
            self.count += 1
            self.total += v
            if v < self.vmin:
                self.vmin = v
            if v > self.vmax:
                self.vmax = v

    def percentile(self, q: float) -> float:
        with self._lock:
            return _hist_percentile(self.counts, self.count, self.scale, self.vmin, self.vmax, q)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            counts = list(self.counts)
            count, total = self.count, self.total
            vmin, vmax = self.vmin, self.vmax
        return {
            "count": count,
            "sum": total,
            "min": 0.0 if count == 0 else vmin,
            "max": vmax,
            "p50": _hist_percentile(counts, count, self.scale, vmin, vmax, 0.50),
            "p99": _hist_percentile(counts, count, self.scale, vmin, vmax, 0.99),
            "scale": self.scale,
            "buckets": counts,
        }


def _hist_percentile(
    counts: Sequence[int], count: int, scale: float, vmin: float, vmax: float, q: float
) -> float:
    if count <= 0:
        return 0.0
    rank = max(1, math.ceil(q * count))
    seen = 0
    for idx, c in enumerate(counts):
        seen += c
        if seen >= rank:
            bound = scale * (2.0 ** idx)
            return min(max(bound, vmin), vmax)
    return vmax


def _is_hist_snapshot(v: Any) -> bool:
    return isinstance(v, dict) and "buckets" in v and "scale" in v


def _merge_hist_snapshots(a: Dict[str, Any], b: Dict[str, Any]) -> Dict[str, Any]:
    if a["scale"] != b["scale"] or len(a["buckets"]) != len(b["buckets"]):
        # incompatible shapes (mismatched knobs) — keep the bigger population
        return a if a["count"] >= b["count"] else b
    counts = [x + y for x, y in zip(a["buckets"], b["buckets"])]
    count = a["count"] + b["count"]
    vmin = min(a["min"] if a["count"] else math.inf, b["min"] if b["count"] else math.inf)
    vmax = max(a["max"], b["max"])
    if count == 0:
        vmin = 0.0
    return {
        "count": count,
        "sum": a["sum"] + b["sum"],
        "min": vmin,
        "max": vmax,
        "p50": _hist_percentile(counts, count, a["scale"], vmin, vmax, 0.50),
        "p99": _hist_percentile(counts, count, a["scale"], vmin, vmax, 0.99),
        "scale": a["scale"],
        "buckets": counts,
    }


def _flatten(prefix: str, value: Any, out: Dict[str, Any]) -> None:
    """Dotted-name flattening for collector output: nested dicts become
    ``prefix.key`` entries; scalars/lists pass through as-is."""
    if isinstance(value, dict) and not _is_hist_snapshot(value):
        for k, v in value.items():
            _flatten(f"{prefix}.{k}" if prefix else str(k), v, out)
    else:
        out[prefix] = value


class MetricsRegistry:
    """Typed instruments plus pull-style collectors, scraped flat.

    ``counter()``/``gauge()``/``histogram()`` are get-or-create and return a
    live instrument (cache the reference on hot paths).
    ``add_collector(prefix, fn)`` registers a zero-arg callable whose dict
    result is flattened under ``prefix`` at every :meth:`snapshot` — the
    bridge that folds the pre-existing subsystem ``stats()`` dicts into the
    registry without double-counting.
    """

    def __init__(self, site: str = "", *, hist_buckets: int = HIST_BUCKETS):
        self.site = site
        self.hist_buckets = hist_buckets
        self._metrics: Dict[str, Any] = {}
        self._collectors: List[Tuple[str, Callable[[], Dict[str, Any]]]] = []
        self._lock = threading.Lock()

    def _get(self, name: str, cls: type, **kw: Any) -> Any:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, **kw)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name!r} already registered as {type(m).__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, *, scale: float = 1e-7) -> Histogram:
        return self._get(name, Histogram, scale=scale, buckets=self.hist_buckets)

    def add_collector(self, prefix: str, fn: Callable[[], Dict[str, Any]]) -> None:
        with self._lock:
            self._collectors.append((prefix, fn))

    def snapshot(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        with self._lock:
            metrics = list(self._metrics.items())
            collectors = list(self._collectors)
        for name, m in metrics:
            out[name] = m.snapshot()
        for prefix, fn in collectors:
            _flatten(prefix, fn(), out)
        return out


def fold_snapshots(snapshots: Iterable[Dict[str, Any]]) -> Dict[str, Any]:
    """Fold N registry snapshots into one: numeric values sum, histogram
    snapshots merge (percentiles recomputed from merged buckets), and
    non-numeric values (state strings, lists) keep the first occurrence."""
    out: Dict[str, Any] = {}
    for snap in snapshots:
        for k, v in snap.items():
            cur = out.get(k)
            if cur is None:
                out[k] = v
            elif _is_hist_snapshot(cur) and _is_hist_snapshot(v):
                out[k] = _merge_hist_snapshots(cur, v)
            elif isinstance(cur, (int, float)) and isinstance(v, (int, float)) \
                    and not isinstance(cur, bool) and not isinstance(v, bool):
                out[k] = cur + v
            # else: first occurrence wins
    return out


# ---------------------------------------------------------------------------
# Tracing
# ---------------------------------------------------------------------------


class Span:
    """One timed event in a trace.  ``status`` is one of ``ok`` / ``retried``
    / ``fenced`` / ``degraded`` / ``unavailable`` / ``error``; ``wire_s`` is
    the *modeled* channel time attributed to this span (the simulated-network
    component of its wall-clock duration).  IDs are process-unique ints; the
    human-readable origin is ``site``."""

    __slots__ = (
        "trace_id", "span_id", "parent_id", "name", "site",
        "start", "end", "status", "wire_s", "tags",
    )

    def __init__(
        self,
        trace_id: int,
        span_id: int,
        parent_id: Optional[int],
        name: str,
        site: str,
        start: float,
        tags: Optional[Dict[str, Any]] = None,
    ):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.site = site
        self.start = start
        self.end = start
        self.status = "ok"
        self.wire_s = 0.0
        self.tags = tags

    def to_dict(self) -> Dict[str, Any]:
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "site": self.site,
            "start": self.start,
            "end": self.end,
            "status": self.status,
            "wire_s": self.wire_s,
            "tags": dict(self.tags) if self.tags else {},
        }


class SpanBuffer:
    """Bounded span sink (deque; oldest spans age out first)."""

    def __init__(self, maxlen: int = TRACE_BUFFER_SPANS):
        self._spans: "deque[Span]" = deque(maxlen=max(16, int(maxlen)))

    def add(self, span: Span) -> None:
        self._spans.append(span)

    def __len__(self) -> int:
        return len(self._spans)

    def spans(self) -> List[Span]:
        return list(self._spans)

    def for_trace(self, trace_id: int) -> List[Span]:
        return [s for s in list(self._spans) if s.trace_id == trace_id]

    def clear(self) -> None:
        self._spans.clear()


# exception type name -> span status; by-name so core.telemetry stays
# dependency-free (rpc.py imports this module, not the other way around)
_EXC_STATUS = {
    "RpcFenced": "fenced",
    "RpcUnavailable": "unavailable",
    "RpcTimeout": "unavailable",
}


class _NullCtx:
    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc: Any) -> None:
        return None


_NULL_CTX = _NullCtx()


class _SpanCtx:
    """Context manager that pushes a span on the tracer's thread-local stack
    so nested spans (and RPC envelopes) parent to it."""

    __slots__ = ("_tracer", "_name", "_parent", "_tags", "_span")

    def __init__(self, tracer: "Tracer", name: str, parent: Optional[Tuple[int, int]],
                 tags: Optional[Dict[str, Any]]):
        self._tracer = tracer
        self._name = name
        self._parent = parent
        self._tags = tags

    def __enter__(self) -> Span:
        tr = self._tracer
        parent = self._parent if self._parent is not None else tr.current()
        span = tr.start_span(self._name, parent=parent, tags=self._tags)
        self._span = span
        tr._stack().append(span)
        return span

    def __exit__(self, exc_type: Any, exc: Any, tb: Any) -> None:
        tr = self._tracer
        span = self._span
        stack = tr._stack()
        if stack and stack[-1] is span:
            stack.pop()
        span.end = now()
        if exc_type is not None and span.status == "ok":
            span.status = _EXC_STATUS.get(exc_type.__name__, "error")
        tr.buffer.add(span)


class Tracer:
    """Mints IDs, tracks the active span per thread, records into a buffer.

    Two usage shapes:

    - ``with tracer.span("ws.write", path=p) as sp:`` — pushes on the
      thread-local context stack; nested ``span()`` calls and RPC envelopes
      parent to it.  A ``span()`` with no active context starts a new trace
      (``last_trace`` remembers its id for tools/tests).
    - ``sp = tracer.start_span(...)`` / ``tracer.finish(sp, ...)`` — the
      allocation-light pair used on the RPC hot path; leaf spans never touch
      the context stack.

    ``enabled=False`` turns every entry point into a near-free no-op.
    """

    def __init__(self, site: str, buffer: SpanBuffer, enabled: bool = True):
        self.site = site
        self.buffer = buffer
        self.enabled = enabled
        self.last_trace: Optional[int] = None
        #: process-unique id base: ids are ``(site_number << 40) | counter``
        self._id_base = next(_SITE_IDS) << 40
        self._ids = itertools.count(1)
        self._local = threading.local()

    def _stack(self) -> List[Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def current(self) -> Optional[Tuple[int, int]]:
        """Active ``(trace_id, span_id)`` on this thread, or None."""
        stack = getattr(self._local, "stack", None)
        if stack:
            top = stack[-1]
            return (top.trace_id, top.span_id)
        return None

    def annotate(self, status: Optional[str] = None, **tags: Any) -> None:
        """Amend the active span (e.g. mark a write ``degraded`` after the
        quorum fallback succeeded)."""
        stack = getattr(self._local, "stack", None)
        if not stack:
            return
        top = stack[-1]
        if status is not None:
            top.status = status
        if tags:
            if top.tags is None:
                top.tags = {}
            top.tags.update(tags)

    def start_span(
        self,
        name: str,
        parent: Optional[Tuple[int, int]] = None,
        tags: Optional[Dict[str, Any]] = None,
    ) -> Span:
        sid = self._id_base | next(self._ids)
        if parent is not None:
            tid, pid = parent
        else:
            tid, pid = sid, None  # a root span's id doubles as the trace id
            self.last_trace = tid
        return Span(tid, sid, pid, name, self.site, now(), tags)

    def finish(self, span: Span, status: str = "ok", wire_s: float = 0.0) -> None:
        span.end = now()
        span.status = status
        span.wire_s = wire_s
        self.buffer.add(span)

    def record(
        self,
        name: str,
        parent: Optional[Tuple[int, int]] = None,
        status: str = "ok",
        wire_s: float = 0.0,
        start: Optional[float] = None,
        end: Optional[float] = None,
        tags: Optional[Dict[str, Any]] = None,
    ) -> Optional[Span]:
        """One-shot span (instant, or backdated with ``start``/``end`` — the
        datapath reconstructs lane timelines from its analytic makespan);
        parents to the active context when ``parent`` is not given."""
        if not self.enabled:
            return None
        span = self.start_span(name, parent=parent if parent is not None else self.current(),
                               tags=tags)
        if start is not None:
            span.start = start
        span.status = status
        span.wire_s = wire_s
        span.end = now() if end is None else end
        self.buffer.add(span)
        return span

    def span(self, name: str, parent: Optional[Tuple[int, int]] = None, **tags: Any):
        if not self.enabled:
            return _NULL_CTX
        return _SpanCtx(self, name, parent, tags or None)


class Telemetry:
    """Per-node / per-plane bundle: one registry + one span buffer + the
    tracer that writes into it."""

    def __init__(
        self,
        site: str,
        *,
        trace_enabled: Optional[bool] = None,
        trace_buffer_spans: Optional[int] = None,
        hist_buckets: Optional[int] = None,
    ):
        self.site = site
        self.registry = MetricsRegistry(
            site, hist_buckets=HIST_BUCKETS if hist_buckets is None else hist_buckets
        )
        self.spans = SpanBuffer(
            TRACE_BUFFER_SPANS if trace_buffer_spans is None else trace_buffer_spans
        )
        self.tracer = Tracer(
            site, self.spans, enabled=TRACE_ENABLED if trace_enabled is None else trace_enabled
        )

    def add_collector(self, prefix: str, fn: Callable[[], Dict[str, Any]]) -> None:
        self.registry.add_collector(prefix, fn)

    def snapshot(self) -> Dict[str, Any]:
        return self.registry.snapshot()


# ---------------------------------------------------------------------------
# Trace assembly / rendering
# ---------------------------------------------------------------------------


def assemble_trace(spans: Sequence[Span]) -> Optional[Dict[str, Any]]:
    """Stitch spans (from any number of buffers) into a parent-linked tree.

    Spans whose parent aged out of a bounded buffer surface as extra roots
    rather than disappearing.  Children sort by start time.
    """
    if not spans:
        return None
    nodes: Dict[int, Dict[str, Any]] = {}
    ordered = sorted(spans, key=lambda s: (s.start, s.span_id))
    for s in ordered:
        node = s.to_dict()
        node["children"] = []
        nodes[s.span_id] = node
    roots: List[Dict[str, Any]] = []
    for s in ordered:
        node = nodes[s.span_id]
        parent = nodes.get(s.parent_id) if s.parent_id is not None else None
        if parent is None:
            roots.append(node)
        else:
            parent["children"].append(node)
    return {"trace_id": ordered[0].trace_id, "n_spans": len(ordered), "roots": roots}


def _render_node(node: Dict[str, Any], t0: float, depth: int, lines: List[str]) -> None:
    off_us = (node["start"] - t0) * 1e6
    dur_us = (node["end"] - node["start"]) * 1e6
    wire_us = node["wire_s"] * 1e6
    tags = node.get("tags") or {}
    tag_s = " ".join(f"{k}={v}" for k, v in tags.items())
    lines.append(
        f"{off_us:>10.1f}us {dur_us:>9.1f}us "
        f"{'  ' * depth}{node['name']} [{node['status']}] @{node['site']}"
        + (f" wire={wire_us:.1f}us" if wire_us else "")
        + (f" {tag_s}" if tag_s else "")
    )
    for child in node["children"]:
        _render_node(child, t0, depth + 1, lines)


def render_timeline(tree: Optional[Dict[str, Any]]) -> str:
    """Text timeline of one assembled trace: offset + duration per span,
    indentation showing the parent links."""
    if not tree or not tree.get("roots"):
        return "(empty trace)"
    t0 = min(r["start"] for r in tree["roots"])
    lines = [f"trace {tree['trace_id']} ({tree['n_spans']} spans)"]
    for root in tree["roots"]:
        _render_node(root, t0, 0, lines)
    return "\n".join(lines)


def chrome_trace(spans: Sequence[Span]) -> List[Dict[str, Any]]:
    """Chrome-trace-format event list (load in chrome://tracing / Perfetto).

    Sites map to ``pid`` rows and traces to ``tid`` lanes, so one export of a
    whole buffer shows cross-DC concurrency per operation.
    """
    events: List[Dict[str, Any]] = []
    for s in spans:
        events.append({
            "name": s.name,
            "cat": "scispace",
            "ph": "X",
            "ts": s.start * 1e6,
            "dur": max(0.0, (s.end - s.start) * 1e6),
            "pid": s.site,
            "tid": s.trace_id,
            "args": {
                "status": s.status,
                "wire_us": s.wire_s * 1e6,
                "span_id": s.span_id,
                "parent_id": s.parent_id,
                **(s.tags or {}),
            },
        })
    return events
