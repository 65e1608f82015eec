"""The data plane — striped multi-lane transfers, a consistent chunk cache,
and asynchronous read-ahead for cross-DC byte movement.

The paper's headline result (Fig. 7: +16% write / +41% read on average) is
about the *data* path, but until this module every workspace byte moved as a
naive single-shot ``backend.read()`` followed by one blocking
``channel.transmit(nbytes)`` — the store and the wire paid serially, and a
cross-DC WAN flow ran at single-stream (window-bound) rate.  This module is
the real data plane all :class:`~repro_torch.core.workspace.Workspace` byte
movement rides:

- **striped multi-lane transfers** — reads and writes are split into
  ``stripe_bytes`` chunks and moved over a pool of ``data_lanes`` per-DC
  lanes (:meth:`repro_torch.core.rpc.Channel.split`).  Lanes *share* the link
  capacity but overlap their latency and each carries its own window-bound
  stream, and the PFS store delay of chunk *k+1* overlaps the wire time of
  chunk *k* (pipelined hand-off), so a striped transfer pays the makespan of
  the slowest lane instead of ``store + latency + wire`` serially — exactly
  the GridFTP/bbcp parallel-stream effect, analytically modeled and slept
  once per transfer;
- **a client-side chunk cache for remote-DC reads** — :class:`ChunkCache`
  holds byte extents per path, LRU by bytes, each record carrying a
  *generation* tag and the epoch stamp it was fetched under.  The cache
  subscribes to the collaboration's path-hash
  :class:`~repro_torch.core.plane.InvalidationBus` — the same fabric that keeps the
  attribute cache coherent — so a remote collaborator's write (or an MEU
  export, or a delete) evicts the stale bytes before the next read; a fill
  that completes after an invalidation is discarded by its stale generation,
  so a hit is never stale.  A repeated cross-DC read of a hot shared dataset
  is served from memory at home-DC cost (XUFS's on-close/invalidate client
  caching and the OSDF cache hierarchy, applied to our link model);
- **read-ahead** — :meth:`DataPath.prefetch` moves ranges in a background
  worker whose modeled transfer time overlaps the foreground's, feeding the
  scidata "next dataset in directory order" access pattern
  (:meth:`~repro_torch.core.workspace.Workspace.read_dataset`).  In-flight
  prefetches are deduplicated against foreground reads, and a prefetched
  chunk invalidated mid-flight never lands (generation check at insert).

Knobs (``stripe_bytes``, ``data_lanes``, ``chunk_cache_bytes``,
``readahead``) ride ``configs/scispace_testbed.py`` → ``Workspace``;
``benchmarks/fig12_datapath.py`` measures the three pieces and
``scripts/bench_gate.py`` pins their ratios.

Fault tolerance: when a :class:`~repro_torch.core.rpc.RetryPolicy` is installed
(``retry=``), an interrupted striped transfer **resumes from the last
completed stripe** instead of restarting from byte zero.  :meth:`_fetch`
re-checks mover liveness between streams and raises
:class:`TransferInterrupted` carrying the ranges already delivered;
:meth:`_fetch_resumable` keeps those parts and refetches only the
``subtract_ranges`` remainder after a decorrelated-jitter backoff.  Writes
resume from the last durably-stored chunk — per-chunk offset rewrites are
idempotent, so a replayed chunk never corrupts the file.  A link-level
partition in an installed :class:`~repro_torch.core.faults.FaultPlan` blocks the
data path (``link_blocked``) even while both DCs stay up; cache hits bypass
the liveness check, so warmed bytes stay readable through the partition.
"""

from __future__ import annotations

import queue
import random
import threading
import time
from collections import OrderedDict
from typing import TYPE_CHECKING, Any, Dict, List, Optional, Sequence, Tuple

from .metadata import path_hash
from .rpc import Channel, RetryPolicy, RpcError, RpcTimeout, RpcUnavailable
from .telemetry import now as _tel_now

if TYPE_CHECKING:  # pragma: no cover - type-only, avoids a cluster<->datapath cycle
    from .cluster import Collaboration, DataCenter

__all__ = [
    "ChunkCache",
    "DataPath",
    "TransferInterrupted",
    "STRIPE_BYTES",
    "DATA_LANES",
    "CHUNK_CACHE_BYTES",
    "RANGE_ALIGN",
]

#: Default stripe chunk size.  Small enough that fig7-sized files (256-512 KB)
#: still split across lanes, large enough that per-chunk PFS latency does not
#: dominate large transfers.
STRIPE_BYTES = 256 << 10
#: Default number of concurrent lanes per DC link (GridFTP-style parallelism).
DATA_LANES = 4
#: Default chunk-cache capacity in bytes (0 disables caching).
CHUNK_CACHE_BYTES = 128 << 20
#: Ranged reads (scidata headers, dataset slices) are widened to this
#: alignment before fetching, so the 2-3 serial ranged reads of a header
#: parse collapse into one cached fetch.
RANGE_ALIGN = 64 << 10

_Range = Tuple[int, int]


class TransferInterrupted(RpcUnavailable):
    """A striped transfer failed mid-flight.

    ``parts`` carries the ``(offset, bytes)`` streams confirmed delivered
    before the failure — a retrying caller keeps them and refetches only the
    remainder (resume-from-last-completed-stripe)."""

    def __init__(self, message: str, *, parts: Sequence[Tuple[int, bytes]] = ()):
        super().__init__(message)
        self.parts: List[Tuple[int, bytes]] = list(parts)


def merge_ranges(ranges: Sequence[_Range]) -> List[_Range]:
    """Sort and coalesce overlapping/adjacent ``[start, end)`` ranges."""
    out: List[_Range] = []
    for s, e in sorted(r for r in ranges if r[1] > r[0]):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def subtract_ranges(ranges: Sequence[_Range], holes: Sequence[_Range]) -> List[_Range]:
    """The parts of ``ranges`` not covered by ``holes`` (both ``[start, end)``)."""
    holes = merge_ranges(holes)
    out: List[_Range] = []
    for s, e in merge_ranges(ranges):
        cur = s
        for hs, he in holes:
            if he <= cur or hs >= e:
                continue
            if hs > cur:
                out.append((cur, min(hs, e)))
            cur = max(cur, he)
            if cur >= e:
                break
        if cur < e:
            out.append((cur, e))
    return out


class _Record:
    """Per-path cache state: generation-tagged byte extents."""

    __slots__ = ("gen", "size", "epoch", "extents", "pending")

    def __init__(self) -> None:
        self.gen = 0
        self.size: Optional[int] = None
        self.epoch = 0
        #: sorted, disjoint, coalesced [start, bytearray] pairs
        self.extents: List[List[Any]] = []
        #: active fills/readers pinning this record against eviction
        self.pending = 0

    def data_bytes(self) -> int:
        return sum(len(buf) for _, buf in self.extents)


class ChunkCache:
    """LRU-by-bytes extent cache for remote-DC file data.

    Consistency contract: every record carries a **generation** counter.  A
    fill snapshots the generation (:meth:`gen_of`) before fetching and hands
    it back at :meth:`insert`; any invalidation in between — a path-hash
    message from the :class:`~repro_torch.core.plane.InvalidationBus`, an explicit
    :meth:`drop`, or an epoch fence at :meth:`pin` — bumps the generation, so
    the late insert is discarded instead of poisoning the cache with stale
    bytes.  Records being filled are pinned (:meth:`pin`/:meth:`unpin`) so
    eviction cannot recycle a generation out from under an in-flight fill.

    The bus interface (:meth:`invalidate_hashes`) matches
    :class:`~repro_torch.core.plane.AttrCache`, so the same collaboration-wide
    publication that keeps attribute reads fresh keeps data reads fresh.
    """

    def __init__(self, max_bytes: int = CHUNK_CACHE_BYTES):
        self.max_bytes = max(0, int(max_bytes))
        self._lock = threading.RLock()
        self._records: "OrderedDict[str, _Record]" = OrderedDict()
        self._by_hash: Dict[str, set] = {}
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        self.hit_bytes = 0
        self.miss_bytes = 0
        self.invalidations = 0
        self.evictions = 0
        self.stale_inserts = 0

    @property
    def enabled(self) -> bool:
        return self.max_bytes > 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._records)

    def data_bytes(self) -> int:
        with self._lock:
            return self._bytes

    def pinned_count(self) -> int:
        """Records currently pinned by an in-flight fill/read — must be zero
        once every transfer (including failed/retried ones) has unwound."""
        with self._lock:
            return sum(1 for rec in self._records.values() if rec.pending > 0)

    # -- record lifecycle ---------------------------------------------------
    def _get_or_create(self, path: str) -> _Record:
        rec = self._records.get(path)
        if rec is None:
            rec = _Record()
            self._records[path] = rec
            self._by_hash.setdefault(path_hash(path), set()).add(path)
        return rec

    def _unindex(self, path: str) -> None:
        h = path_hash(path)
        bucket = self._by_hash.get(h)
        if bucket is not None:
            bucket.discard(path)
            if not bucket:
                del self._by_hash[h]

    def _invalidate_record(self, rec: _Record) -> None:
        rec.gen += 1
        self._bytes -= rec.data_bytes()
        rec.extents = []
        rec.size = None

    def _drop_if_idle(self, path: str, rec: _Record) -> None:
        if rec.pending <= 0 and not rec.extents:
            self._records.pop(path, None)
            self._unindex(path)

    def pin(self, path: str, *, min_epoch: int = 0) -> None:
        """Pin ``path`` for a fill/read; apply the epoch freshness fence.

        If the caller has witnessed a newer epoch for this path than the
        cached bytes were fetched under, the stale extents are invalidated
        here — the second line of defense behind the invalidation bus.
        """
        with self._lock:
            rec = self._get_or_create(path)
            if min_epoch > rec.epoch and rec.extents:
                self._invalidate_record(rec)
                self.invalidations += 1
            rec.epoch = max(rec.epoch, min_epoch)
            rec.pending += 1

    def unpin(self, path: str) -> None:
        with self._lock:
            rec = self._records.get(path)
            if rec is None:
                return
            rec.pending -= 1
            self._drop_if_idle(path, rec)

    def gen_of(self, path: str) -> int:
        """Current generation of a (pinned) record; snapshot before a fill."""
        with self._lock:
            rec = self._records.get(path)
            return -1 if rec is None else rec.gen

    # -- reads --------------------------------------------------------------
    def _missing_locked(self, rec: _Record, start: int, end: int) -> List[_Range]:
        out: List[_Range] = []
        cur = start
        for s, buf in rec.extents:
            e = s + len(buf)
            if e <= cur:
                continue
            if s >= end:
                break
            if s > cur:
                out.append((cur, min(s, end)))
            cur = max(cur, e)
            if cur >= end:
                break
        if cur < end:
            out.append((cur, end))
        return out

    def missing(self, path: str, start: int, end: int) -> List[_Range]:
        """The sub-ranges of ``[start, end)`` the cache does not hold."""
        with self._lock:
            rec = self._records.get(path)
            if rec is None:
                return [(start, end)] if end > start else []
            return self._missing_locked(rec, start, end)

    def read(self, path: str, start: int, end: int) -> Optional[bytes]:
        """Serve ``[start, end)`` if fully cached; ``None`` on any gap."""
        with self._lock:
            rec = self._records.get(path)
            if end <= start:
                return b""
            if rec is None or self._missing_locked(rec, start, end):
                self.misses += 1
                self.miss_bytes += end - start
                return None
            self._records.move_to_end(path)
            self.hits += 1
            self.hit_bytes += end - start
            for s, buf in rec.extents:
                # common case: one extent covers the whole request — a hit is
                # then ONE copy out of the extent, not an assemble
                if s <= start and s + len(buf) >= end:
                    return bytes(memoryview(buf)[start - s : end - s])
            out = bytearray(end - start)
            for s, buf in rec.extents:
                e = s + len(buf)
                if e <= start or s >= end:
                    continue
                lo, hi = max(s, start), min(e, end)
                out[lo - start : hi - start] = memoryview(buf)[lo - s : hi - s]
            return bytes(out)

    def size_of(self, path: str) -> Optional[int]:
        with self._lock:
            rec = self._records.get(path)
            return None if rec is None else rec.size

    # -- fills --------------------------------------------------------------
    def insert(
        self,
        path: str,
        gen: int,
        start: int,
        data: bytes,
        *,
        size: Optional[int] = None,
        epoch: int = 0,
    ) -> bool:
        """Merge a fetched extent, iff the record still has generation ``gen``.

        Returns ``False`` (and stores nothing) when the record was
        invalidated or evicted since the fill began — the no-stale-insert
        guarantee for read-ahead.
        """
        if not self.enabled:
            return False
        with self._lock:
            rec = self._records.get(path)
            if rec is None or rec.gen != gen:
                self.stale_inserts += 1
                return False
            end = start + len(data)
            keep: List[List[Any]] = []
            overlapped: List[List[Any]] = []
            for ext in rec.extents:
                s, buf = ext
                if s + len(buf) < start or s > end:
                    keep.append(ext)
                else:
                    overlapped.append(ext)
            before = rec.data_bytes()
            if overlapped:
                lo = min(start, overlapped[0][0])
                hi = max(end, max(s + len(b) for s, b in overlapped))
                combined = bytearray(hi - lo)
                for s, b in overlapped:
                    combined[s - lo : s - lo + len(b)] = b
                combined[start - lo : end - lo] = data
                keep.append([lo, combined])
            elif data:
                keep.append([start, bytearray(data)])
            keep.sort(key=lambda ext: ext[0])
            rec.extents = keep
            if size is not None:
                rec.size = size
            rec.epoch = max(rec.epoch, epoch)
            self._bytes += rec.data_bytes() - before
            self._records.move_to_end(path)
            self._evict_locked()
            return True

    def _evict_locked(self) -> None:
        while self._bytes > self.max_bytes:
            victim = None
            for p, rec in self._records.items():
                if rec.pending <= 0 and rec.extents:
                    victim = p
                    break
            if victim is None:
                return  # everything live is pinned; allow temporary overage
            rec = self._records.pop(victim)
            self._bytes -= rec.data_bytes()
            self._unindex(victim)
            self.evictions += 1

    # -- invalidation -------------------------------------------------------
    def drop(self, path: str) -> None:
        """Invalidate one path (local write/delete superseding cached bytes)."""
        with self._lock:
            rec = self._records.get(path)
            if rec is None:
                return
            self._invalidate_record(rec)
            self.invalidations += 1
            self._drop_if_idle(path, rec)

    def invalidate_hashes(self, hashes) -> int:
        """InvalidationBus interface: evict every path matching a published
        path hash.  Pinned (in-flight) records keep their bumped generation so
        the racing fill self-discards."""
        dropped = 0
        with self._lock:
            for h in hashes:
                for path in list(self._by_hash.get(h, ())):
                    rec = self._records.get(path)
                    if rec is None:
                        continue
                    self._invalidate_record(rec)
                    self._drop_if_idle(path, rec)
                    dropped += 1
            self.invalidations += dropped
        return dropped

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "entries": len(self._records),
                "bytes": self._bytes,
                "hits": self.hits,
                "misses": self.misses,
                "hit_bytes": self.hit_bytes,
                "miss_bytes": self.miss_bytes,
                "invalidations": self.invalidations,
                "evictions": self.evictions,
                "stale_inserts": self.stale_inserts,
                "pinned": sum(1 for rec in self._records.values() if rec.pending > 0),
            }


class DataPath:
    """One mount's striped/cached/read-ahead engine for cross-DC byte movement.

    All remote transfers flow through :meth:`read` / :meth:`read_range` /
    :meth:`write`; the home-DC fast path stays in the workspace (a local read
    is a plain PFS access — the cache and lanes model the *wide-area* story,
    matching the paper's native-access framing).
    """

    def __init__(
        self,
        collab: "Collaboration",
        home_dc: str,
        *,
        stripe_bytes: int = STRIPE_BYTES,
        data_lanes: int = DATA_LANES,
        chunk_cache_bytes: int = CHUNK_CACHE_BYTES,
        readahead: bool = True,
        range_align: int = RANGE_ALIGN,
        subscribe: bool = True,
        retry: Optional[RetryPolicy] = None,
        tracer: Any = None,
        metrics: Any = None,
    ):
        self.collab = collab
        self.home_dc = home_dc
        self.retry = retry
        self.tracer = tracer
        self._hist_xfer_s = (
            metrics.histogram("datapath.transfer_seconds") if metrics is not None else None
        )
        self._hist_xfer_b = (
            metrics.histogram("datapath.transfer_bytes", scale=1.0)
            if metrics is not None
            else None
        )
        self._retry_rng = (
            random.Random(f"{retry.seed}:datapath:{home_dc}") if retry is not None else None
        )
        self.stripe_bytes = max(0, int(stripe_bytes))
        self.data_lanes = max(1, int(data_lanes))
        self.readahead = bool(readahead)
        self.range_align = max(1, int(range_align))
        self.cache = ChunkCache(chunk_cache_bytes)
        self._single: Dict[str, Channel] = {}
        self._lane_pool: Dict[str, List[Channel]] = {}
        for dc_id in collab.datacenters:
            ch = collab.channel_policy(home_dc, dc_id)
            self._single[dc_id] = ch
            self._lane_pool[dc_id] = ch.split(self.data_lanes)
        self._bus = getattr(collab, "invalidations", None)
        if self._bus is not None and subscribe and self.cache.enabled:
            self._bus.subscribe(self.cache)
        # accounting (foreground + prefetch worker share it)
        self._stats_lock = threading.Lock()
        self.remote_reads = 0
        self.remote_writes = 0
        self.bytes_read = 0
        self.bytes_written = 0
        self.wire_seconds = 0.0
        self.prefetch_issued = 0
        self.prefetch_completed = 0
        self.prefetch_bytes = 0
        self.fallback_reads = 0
        self.interrupted_transfers = 0
        self.transfer_retries = 0
        # read-ahead worker (started lazily on first prefetch)
        self._queue: "queue.Queue[Optional[tuple]]" = queue.Queue()
        self._worker: Optional[threading.Thread] = None
        self._worker_lock = threading.Lock()
        self._inflight: Dict[str, List[Tuple[int, int, threading.Event]]] = {}
        self._inflight_lock = threading.Lock()
        #: test hook: when set, the worker blocks here *between* fetching a
        #: prefetch and inserting it — the window a mid-flight invalidation
        #: must win (tests/test_datapath.py)
        self._insert_gate: Optional[threading.Event] = None
        self._closed = False

    # -- lane / liveness model ---------------------------------------------
    def _require_live(self, dc: "DataCenter") -> None:
        """The DTNs are the data movers (the paper's role for them): a DC with
        every DTN down cannot serve its PFS across the WAN; a fault-plan
        partition blocks the link even while both sides stay up."""
        if dc.dtns and not dc.has_live_dtn():
            raise RpcUnavailable(f"data path to {dc.dc_id} unavailable: no live DTN")
        plan = getattr(self.collab, "fault_plan", None)
        if (
            plan is not None
            and dc.dc_id != self.home_dc
            and plan.link_blocked(self.home_dc, dc.dc_id)
        ):
            raise RpcTimeout(
                f"data path {self.home_dc}->{dc.dc_id} unavailable: link partitioned"
            )

    def _lanes(self, dc_id: str) -> List[Channel]:
        lanes = self._lane_pool.get(dc_id)
        if lanes is None:
            ch = self.collab.channel_policy(self.home_dc, dc_id)
            self._single[dc_id] = ch
            lanes = self._lane_pool[dc_id] = ch.split(self.data_lanes)
        return lanes

    def _handshake_s(self, dc_id: str, n_pieces: int) -> float:
        """One request/ack round-trip opens a *striped* transfer (stat + lane
        setup).  A single-chunk transfer rides the already-open control
        stream — no mover opens a lane pool for one small chunk — so small
        reads and writes cost what the pre-striping path charged."""
        if n_pieces <= 1:
            return 0.0
        ch = self._single.get(dc_id)
        return 2.0 * ch.latency_s if ch is not None else 0.0

    @staticmethod
    def _makespan_in(pieces: List[Tuple[float, int]], lanes: List[Channel]) -> float:
        """Pipelined read makespan: per lane, store fetches are a serial
        stream whose chunk *k+1* overlaps chunk *k*'s wire time; lanes
        overlap each other and each pays its one-way latency once."""
        if not pieces:
            return 0.0
        n = len(lanes)
        fetch_done = [0.0] * n
        send_done = [0.0] * n
        for k, (store_s, nbytes) in enumerate(pieces):
            lane = k % n
            fetch_done[lane] += store_s
            send_done[lane] = max(send_done[lane], fetch_done[lane]) + lanes[
                lane
            ].payload_seconds(nbytes)
        return max(
            send_done[i] + lanes[i].latency_s for i in range(n) if send_done[i] > 0 or i == 0
        )

    @staticmethod
    def _makespan_out(pieces: List[Tuple[float, int]], lanes: List[Channel]) -> float:
        """Pipelined write makespan: wire then store, mirrored."""
        if not pieces:
            return 0.0
        n = len(lanes)
        send_done = [0.0] * n
        store_done = [0.0] * n
        for k, (store_s, nbytes) in enumerate(pieces):
            lane = k % n
            send_done[lane] += lanes[lane].payload_seconds(nbytes)
            store_done[lane] = (
                max(store_done[lane], send_done[lane] + lanes[lane].latency_s) + store_s
            )
        return max(store_done)

    @staticmethod
    def _lane_profile(
        pieces: List[Tuple[float, int]], lanes: List[Channel], *, inbound: bool
    ) -> List[Tuple[int, float, int, float]]:
        """Per-lane ``(lane, finish_s, bytes, wire_s)`` replaying the same
        round-robin hand-off as :meth:`_makespan_in`/:meth:`_makespan_out` —
        the trace's lane child spans are reconstructed from this, not
        separately timed."""
        n = len(lanes)
        first = [0.0] * n  # store-fetch stream (in) / wire stream (out)
        second = [0.0] * n  # wire stream (in) / store stream (out)
        lane_bytes = [0] * n
        lane_wire = [0.0] * n
        for k, (store_s, nbytes) in enumerate(pieces):
            lane = k % n
            w = lanes[lane].payload_seconds(nbytes)
            lane_bytes[lane] += nbytes
            lane_wire[lane] += w
            if inbound:
                first[lane] += store_s
                second[lane] = max(second[lane], first[lane]) + w
            else:
                first[lane] += w
                second[lane] = (
                    max(second[lane], first[lane] + lanes[lane].latency_s) + store_s
                )
        out: List[Tuple[int, float, int, float]] = []
        for i in range(n):
            if lane_bytes[i] <= 0:
                continue
            finish = second[i] + (lanes[i].latency_s if inbound else 0.0)
            out.append((i, finish, lane_bytes[i], lane_wire[i] + lanes[i].latency_s))
        return out

    def _trace_transfer(
        self,
        name: str,
        dc_id: str,
        makespan: float,
        pieces: List[Tuple[float, int]],
        moved: int,
        failed: bool,
        *,
        inbound: bool,
    ) -> None:
        """Record a ``data.read``/``data.write`` span (plus per-lane children
        for striped transfers) backdated over the makespan just slept.  Only
        fires under an active trace context — the foreground op's span or a
        ``data.prefetch`` root in the worker thread."""
        tracer = self.tracer
        if tracer is None or not tracer.enabled:
            return
        ctx = tracer.current()
        if ctx is None:
            return
        t_end = _tel_now()
        t0 = t_end - makespan
        lanes = self._lanes(dc_id)
        sp = tracer.record(
            name,
            parent=ctx,
            status="unavailable" if failed else "ok",
            wire_s=makespan,
            start=t0,
            end=t_end,
            tags={"dc": dc_id, "bytes": moved, "chunks": len(pieces), "lanes": len(lanes)},
        )
        if sp is None or len(pieces) <= 1:
            return  # single-chunk transfers ride the control stream: no lane fan-out
        t_lanes = t0 + self._handshake_s(dc_id, len(pieces))
        pctx = (sp.trace_id, sp.span_id)
        for lane, finish, nbytes, wire in self._lane_profile(pieces, lanes, inbound=inbound):
            tracer.record(
                "data.lane",
                parent=pctx,
                wire_s=wire,
                start=t_lanes,
                end=t_lanes + finish,
                tags={"lane": lane, "bytes": nbytes},
            )

    # -- transfers ----------------------------------------------------------
    def _chop(self, start: int, end: int) -> List[_Range]:
        if end <= start:
            return []
        if self.stripe_bytes <= 0:
            return [(start, end)]
        out = []
        off = start
        while off < end:
            out.append((off, min(end, off + self.stripe_bytes)))
            off = out[-1][1]
        return out

    def _fetch(
        self, dc_id: str, path: str, ranges: Sequence[_Range], *, prefetch: bool = False
    ) -> List[Tuple[int, bytes]]:
        """Move byte ranges from ``dc_id``'s PFS over the lane pool.

        Each merged range is ONE streaming store op (deferred — one PFS
        open/seek, not one per stripe chunk); the stripe chunks only pace the
        lanes, each carrying its proportional share of the stream's store
        time.  The pipelined makespan is computed analytically and slept
        once — the wall-clock a real laned, pipelined transfer pays.
        Nothing is cached here; the caller owns generation-checked
        insertion."""
        dc = self.collab.dc(dc_id)
        self._require_live(dc)
        backend = dc.backend
        parts: List[Tuple[int, bytes]] = []
        pieces: List[Tuple[float, int]] = []
        failure: Optional[RpcUnavailable] = None
        for s, e in merge_ranges(ranges):
            if parts:
                # liveness re-checked between streams: streams whose
                # completion a live check has witnessed are confirmed
                # delivered; everything after the failure is not
                try:
                    self._require_live(dc)
                except RpcUnavailable as exc:
                    failure = exc
                    break
            data, store_s = backend.read_deferred(path, offset=s, length=e - s)
            if data:
                parts.append((s, data))
                chunks = self._chop(s, s + len(data))
                for cs, ce in chunks:
                    pieces.append((store_s * (ce - cs) / len(data), ce - cs))
            if len(data) < e - s:
                break  # short read: EOF inside the range
        if failure is None:
            # a DTN crash while chunks were in flight fails the transfer
            try:
                self._require_live(dc)
            except RpcUnavailable as exc:
                failure = exc
        if failure is not None and parts:
            # the most recently read stream was in flight at the failure —
            # not confirmed; drop it (and its lane pieces) so a resume
            # refetches it rather than trusting a possibly-torn stream
            s, data = parts.pop()
            del pieces[len(pieces) - len(self._chop(s, s + len(data))) :]
        makespan = self._handshake_s(dc_id, len(pieces)) + self._makespan_in(
            pieces, self._lanes(dc_id)
        )
        if makespan > 0:
            time.sleep(makespan)
        moved = sum(len(d) for _, d in parts)
        with self._stats_lock:
            self.wire_seconds += makespan
            if failure is not None:
                self.interrupted_transfers += 1
            if prefetch:
                self.prefetch_bytes += moved
            else:
                self.remote_reads += 1
                self.bytes_read += moved
        if self._hist_xfer_s is not None and makespan > 0.0:
            self._hist_xfer_s.observe(makespan)
            self._hist_xfer_b.observe(moved)
        self._trace_transfer(
            "data.read", dc_id, makespan, pieces, moved, failure is not None, inbound=True
        )
        if failure is not None:
            raise TransferInterrupted(str(failure), parts=parts)
        return parts

    def _fetch_resumable(
        self, dc_id: str, path: str, ranges: Sequence[_Range], *, prefetch: bool = False
    ) -> List[Tuple[int, bytes]]:
        """:meth:`_fetch` under the retry policy: an interrupted transfer
        keeps the streams already delivered and refetches only the
        ``subtract_ranges`` remainder after a decorrelated-jitter backoff —
        resume from the last completed stripe, not byte zero.  With no policy
        installed this is exactly ``_fetch`` (fail-fast)."""
        policy = self.retry
        if policy is None:
            return self._fetch(dc_id, path, ranges, prefetch=prefetch)
        have: List[Tuple[int, bytes]] = []
        remaining = merge_ranges(ranges)
        deadline = time.perf_counter() + policy.deadline_s
        backoff = policy.base_s
        attempt = 1
        while True:
            try:
                have.extend(self._fetch(dc_id, path, remaining, prefetch=prefetch))
                return have
            except RpcUnavailable as exc:
                kept = getattr(exc, "parts", ())
                if kept:
                    have.extend(kept)
                    remaining = subtract_ranges(
                        remaining, [(s, s + len(d)) for s, d in kept]
                    )
                    if not remaining:
                        return have
                backoff = min(
                    policy.cap_s, self._retry_rng.uniform(policy.base_s, backoff * 3.0)
                )
                if attempt >= policy.max_attempts or time.perf_counter() + backoff > deadline:
                    raise
                attempt += 1
                with self._stats_lock:
                    self.transfer_retries += 1
                time.sleep(backoff)

    @staticmethod
    def _coalesce_parts(parts: List[Tuple[int, bytes]]) -> List[Tuple[int, bytes]]:
        """Join contiguous fetched chunks into runs so each run is ONE cache
        insert — per-chunk inserts would re-copy the growing extent per chunk
        (quadratic in chunks per range)."""
        runs: List[Tuple[int, bytes]] = []
        start = end = 0
        bufs: List[bytes] = []
        for off, data in sorted(parts):
            if bufs and off == end:
                bufs.append(data)
                end += len(data)
            else:
                if bufs:
                    runs.append((start, b"".join(bufs)))
                start, end, bufs = off, off + len(data), [data]
        if bufs:
            runs.append((start, b"".join(bufs)))
        return runs

    def read(self, dc_id: str, path: str, *, epoch: int = 0) -> bytes:
        """Whole-file remote read: striped, cached, byte-identical."""
        size = self.collab.dc(dc_id).backend.stat(path).size
        return self._read(dc_id, path, 0, size, size, epoch)

    def read_range(
        self, dc_id: str, path: str, offset: int, length: int, *, epoch: int = 0
    ) -> bytes:
        """Ranged remote read (scidata headers/datasets), chunk-cached with
        ``range_align`` widening so adjacent small reads coalesce."""
        size = self.collab.dc(dc_id).backend.stat(path).size
        start = max(0, int(offset))
        end = size if length < 0 else min(size, start + int(length))
        return self._read(dc_id, path, start, min(start, size), size, epoch) if end <= start else self._read(
            dc_id, path, start, end, size, epoch
        )

    def _align(self, start: int, end: int, size: int) -> _Range:
        a = self.range_align
        return (start // a) * a, min(size, ((end + a - 1) // a) * a)

    def _inflight_overlaps(
        self, path: str, start: int, end: int
    ) -> Tuple[List[_Range], List[threading.Event]]:
        with self._inflight_lock:
            spans, events = [], []
            for s, e, ev in self._inflight.get(path, ()):
                if e > start and s < end:
                    spans.append((s, e))
                    events.append(ev)
            return spans, events

    def _read(
        self, dc_id: str, path: str, start: int, end: int, size: int, epoch: int
    ) -> bytes:
        if end <= start:
            return b""
        if not self.cache.enabled:
            parts = self._fetch_resumable(dc_id, path, [(start, end)])
            return b"".join(d for _, d in sorted(parts))
        self.cache.pin(path, min_epoch=epoch)
        try:
            for _ in range(4):
                got = self.cache.read(path, start, end)
                if got is not None:
                    return got
                gen = self.cache.gen_of(path)
                missing = self.cache.missing(path, start, end)
                inflight, events = self._inflight_overlaps(path, start, end)
                to_fetch = subtract_ranges(missing, inflight)
                if to_fetch:
                    aligned = merge_ranges([self._align(s, e, size) for s, e in to_fetch])
                    parts = self._coalesce_parts(self._fetch_resumable(dc_id, path, aligned))
                    for off, data in parts:
                        self.cache.insert(path, gen, off, data, size=size, epoch=epoch)
                for ev in events:
                    ev.wait(timeout=30.0)
                if not to_fetch and not events:
                    break  # invalidated underneath us with nothing in flight
            # the cache kept getting invalidated (or a prefetch failed):
            # serve correctness over caching with one direct fetch
            with self._stats_lock:
                self.fallback_reads += 1
            parts = self._fetch_resumable(dc_id, path, [(start, end)])
            return b"".join(d for _, d in sorted(parts))
        finally:
            self.cache.unpin(path)

    def _write_chunks(
        self,
        dc: "DataCenter",
        path: str,
        data: bytes,
        chunks: List[_Range],
        start_idx: int,
        *,
        owner: str,
    ) -> int:
        """Ship ``chunks[start_idx:]`` to the owner PFS, re-checking mover
        liveness between chunks.  Returns the index one past the last chunk
        *confirmed* stored; on failure raises after accounting the confirmed
        prefix, so a retry resumes there (offset rewrites are idempotent)."""
        self._require_live(dc)
        backend = dc.backend
        pieces: List[Tuple[float, int]] = []
        done = start_idx
        failure: Optional[RpcUnavailable] = None
        for cs, ce in chunks[start_idx:]:  # ascending: the offset-0 chunk truncates first
            if pieces:
                try:
                    self._require_live(dc)
                except RpcUnavailable as exc:
                    failure = exc
                    break
            _, store_s = backend.write_deferred(path, data[cs:ce], offset=cs, owner=owner)
            pieces.append((store_s, ce - cs))
            done += 1
        if failure is None:
            try:
                self._require_live(dc)
            except RpcUnavailable as exc:
                failure = exc
        if failure is not None and pieces:
            # the chunk in flight at the failure is not confirmed durable —
            # the resume rewrites it at the same offset
            pieces.pop()
            done -= 1
        makespan = self._handshake_s(dc.dc_id, len(pieces)) + self._makespan_out(
            pieces, self._lanes(dc.dc_id)
        )
        if makespan > 0:
            time.sleep(makespan)
        moved = sum(n for _, n in pieces)
        with self._stats_lock:
            self.wire_seconds += makespan
            self.bytes_written += moved
            if failure is not None:
                self.interrupted_transfers += 1
        if self._hist_xfer_s is not None and makespan > 0.0:
            self._hist_xfer_s.observe(makespan)
            self._hist_xfer_b.observe(moved)
        self._trace_transfer(
            "data.write", dc.dc_id, makespan, pieces, moved, failure is not None, inbound=False
        )
        if failure is not None:
            wrapped = TransferInterrupted(str(failure))
            wrapped.chunks_done = done  # resume point for a retried write
            raise wrapped
        return done

    def write(self, dc_id: str, path: str, data: bytes, *, owner: str = "", epoch: int = 0) -> int:
        """Striped multi-lane remote write, write-through into the cache.

        Under the retry policy an interrupted write resumes from the last
        confirmed chunk — never from byte zero, and never double-counting
        bytes (a replayed chunk rewrites the same offset)."""
        dc = self.collab.dc(dc_id)
        chunks = self._chop(0, len(data)) or [(0, 0)]
        policy = self.retry
        done = 0
        if policy is None:
            self._write_chunks(dc, path, data, chunks, 0, owner=owner)
        else:
            deadline = time.perf_counter() + policy.deadline_s
            backoff = policy.base_s
            attempt = 1
            while True:
                try:
                    self._write_chunks(dc, path, data, chunks, done, owner=owner)
                    break
                except RpcUnavailable as exc:
                    done = getattr(exc, "chunks_done", done)
                    backoff = min(
                        policy.cap_s,
                        self._retry_rng.uniform(policy.base_s, backoff * 3.0),
                    )
                    if (
                        attempt >= policy.max_attempts
                        or time.perf_counter() + backoff > deadline
                    ):
                        raise
                    attempt += 1
                    with self._stats_lock:
                        self.transfer_retries += 1
                    time.sleep(backoff)
        with self._stats_lock:
            self.remote_writes += 1
        if self.cache.enabled:
            # our own bytes are the freshest possible copy: supersede any
            # cached extents (a shorter overwrite must not leave a stale
            # tail) and repopulate, so read-back is a home-DC-cost hit
            self.cache.pin(path, min_epoch=epoch)
            try:
                self.cache.drop(path)
                self.cache.insert(
                    path, self.cache.gen_of(path), 0, bytes(data), size=len(data), epoch=epoch
                )
            finally:
                self.cache.unpin(path)
        return len(data)

    def invalidate(self, path: str) -> None:
        """Drop cached bytes for ``path`` (local delete/overwrite supersedes)."""
        self.cache.drop(path)

    # -- read-ahead ---------------------------------------------------------
    def prefetch(self, dc_id: str, path: str, ranges: Sequence[_Range], *, epoch: int = 0) -> bool:
        """Queue an asynchronous fill of ``ranges`` (absolute ``(start, end)``).

        Best-effort: requires the cache (the prefetched bytes need somewhere
        to land) and a remote target; failures and mid-flight invalidations
        are absorbed — the foreground read path re-fetches whatever did not
        arrive."""
        if (
            not self.readahead
            or not self.cache.enabled
            or self._closed
            or dc_id == self.home_dc
            or not ranges
        ):
            return False
        self._ensure_worker()
        self._queue.put((dc_id, path, [tuple(r) for r in ranges], epoch))
        with self._stats_lock:
            self.prefetch_issued += 1
        return True

    def _ensure_worker(self) -> None:
        with self._worker_lock:
            if self._worker is None or not self._worker.is_alive():
                self._worker = threading.Thread(
                    target=self._worker_loop, name="datapath-readahead", daemon=True
                )
                self._worker.start()

    def _worker_loop(self) -> None:
        while True:
            job = self._queue.get()
            try:
                if job is None:
                    return
                self._do_prefetch(*job)
            except Exception:  # noqa: BLE001 - prefetch is strictly best-effort
                pass
            finally:
                self._queue.task_done()

    def _do_prefetch(self, dc_id: str, path: str, ranges: List[_Range], epoch: int) -> None:
        tracer = self.tracer
        if tracer is not None and tracer.enabled:
            # the worker thread has no foreground context, so this span roots
            # its own trace — overlap with foreground reads (fig12) is visible
            # as concurrent data.prefetch roots in the buffer
            with tracer.span("data.prefetch", path=path, dc=dc_id):
                self._do_prefetch_inner(dc_id, path, ranges, epoch)
        else:
            self._do_prefetch_inner(dc_id, path, ranges, epoch)

    def _do_prefetch_inner(
        self, dc_id: str, path: str, ranges: List[_Range], epoch: int
    ) -> None:
        size = self.collab.dc(dc_id).backend.stat(path).size
        wanted = merge_ranges(
            [self._align(max(0, s), min(size, e), size) for s, e in ranges if e > s]
        )
        self.cache.pin(path, min_epoch=epoch)
        ev = threading.Event()
        registered: List[_Range] = []
        try:
            gen = self.cache.gen_of(path)
            missing: List[_Range] = []
            for s, e in wanted:
                missing.extend(self.cache.missing(path, s, e))
            with self._inflight_lock:
                others = [(s, e) for s, e, _ in self._inflight.get(path, ())]
                registered = subtract_ranges(missing, others)
                if registered:
                    self._inflight.setdefault(path, []).extend(
                        (s, e, ev) for s, e in registered
                    )
            if not registered:
                return
            parts = self._coalesce_parts(
                self._fetch_resumable(dc_id, path, registered, prefetch=True)
            )
            gate = self._insert_gate
            if gate is not None:
                gate.wait(timeout=30.0)  # test hook: hold the insert window open
            for off, data in parts:
                self.cache.insert(path, gen, off, data, size=size, epoch=epoch)
            with self._stats_lock:
                self.prefetch_completed += 1
        finally:
            if registered:
                with self._inflight_lock:
                    entries = self._inflight.get(path, [])
                    entries[:] = [t for t in entries if t[2] is not ev]
                    if not entries:
                        self._inflight.pop(path, None)
            ev.set()
            self.cache.unpin(path)

    def drain_prefetch(self, timeout_s: float = 30.0) -> None:
        """Block until every queued prefetch has been processed (tests)."""
        deadline = time.time() + timeout_s
        while not self._queue.empty() or any(self._inflight.values()):
            if time.time() > deadline:
                return
            time.sleep(0.001)
        # one settled pass for a job popped but not yet registered
        self._queue.join()

    # -- accounting / lifecycle --------------------------------------------
    def _own_stats(self) -> Dict[str, Any]:
        with self._stats_lock:
            return {
                "remote_reads": self.remote_reads,
                "remote_writes": self.remote_writes,
                "bytes_read": self.bytes_read,
                "bytes_written": self.bytes_written,
                "wire_seconds": self.wire_seconds,
                "prefetch_issued": self.prefetch_issued,
                "prefetch_completed": self.prefetch_completed,
                "prefetch_bytes": self.prefetch_bytes,
                "fallback_reads": self.fallback_reads,
                "interrupted_transfers": self.interrupted_transfers,
                "transfer_retries": self.transfer_retries,
            }

    def stats(self) -> Dict[str, Any]:
        """Legacy flat shape (``cache_<k>`` keys) — same source of truth as
        :meth:`stats_flat`, which the telemetry registry scrapes."""
        out = self._own_stats()
        for k, v in self.cache.stats().items():
            out[f"cache_{k}"] = v
        return out

    def stats_flat(self) -> Dict[str, Any]:
        """Registry collector: nested ``cache`` dict flattens to the
        documented ``datapath.cache.*`` metric names."""
        out = self._own_stats()
        out["cache"] = self.cache.stats()
        return out

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        with self._worker_lock:
            worker = self._worker
        if worker is not None and worker.is_alive():
            self._queue.put(None)
            worker.join(timeout=5.0)
        if self._bus is not None:
            self._bus.unsubscribe(self.cache)
