"""The unified metadata plane — client-side service interaction layer.

Every SCISPACE client (workspace mount, MEU, benchmark harness) used to
hand-roll its own per-DTN ``RpcClient`` loops, so the hot paths could neither
pipeline nor cache nor bound their fan-out.  This module centralizes all of
that behind one object per mount:

- **pooled clients** — one metadata + one discovery :class:`~repro_torch.core.rpc.RpcClient`
  per DTN, built once over the collaboration's channel policy;
- **batched / pipelined calls** — :meth:`ServicePlane.meta_batch` and friends
  ride :meth:`RpcClient.call_batch`, so N ops on one channel pay one channel
  round-trip plus N serializations (the MEU coalescing of §III-B3 applied to
  every service surface);
- **scatter-gather fan-out** — :meth:`ServicePlane.scatter` /
  :meth:`ServicePlane.scatter_batch` contact many DTNs "concurrently" with a
  bounded in-flight window.  Because the whole fabric is in-process, true
  thread fan-out would serialize on the GIL and this container's ~0.5 ms
  timer granularity; instead the calls run back-to-back with *deferred* wire
  delays and the plane sleeps once per window for the slowest link — the
  wall-clock a real concurrent fan-out pays (service CPU would serialize
  under the GIL either way).  ``max_inflight`` bounds the window size;
- **write-back attribute cache** — :class:`AttrCache` holds file metadata
  entries keyed by path, invalidated collaboration-wide by *path hash*
  through :class:`InvalidationBus` (the same hash that places the entry on
  its owner DTN, §III-B1).  A plane's own writes update the cache in place;
  other clients' writes reach it as invalidations, so reads never serve a
  row another collaborator has replaced.  In write-back mode the final
  "flush" op of the FUSE five-op sequence (the size/mtime update) is
  buffered as a dirty cache entry and committed later as one batched
  ``update`` per owner DTN (:meth:`ServicePlane.flush`).

XUFS (arXiv:1001.0196) and the OSDF (arXiv:2605.15437) both show wide-area
file federations live or die on exactly this request coalescing + namespace
caching; this is the repo's version of that lesson.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import TYPE_CHECKING, Any, Dict, Iterable, List, Optional, Sequence, Tuple

from itertools import count

from .leases import DEFAULT_LEASE_TTL_S, Lease, LeaseManager
from .metadata import hash_placement, path_hash
from .query import ShardSummary
from .replication import WB_MAX_AGE_S, WB_MAX_PENDING, WriteBackJournal
from .rpc import RetryPolicy, RpcClient, RpcError, RpcFenced, RpcUnavailable
from .telemetry import Telemetry, fold_snapshots

if TYPE_CHECKING:  # pragma: no cover - type-only, avoids a cluster<->plane cycle
    from .cluster import Collaboration

__all__ = ["AttrCache", "CircuitBreaker", "InvalidationBus", "ServicePlane", "WRITE_QUORUM"]

#: Circuit-breaker defaults (overridable per plane / per workspace).
BREAKER_THRESHOLD = 3
BREAKER_COOLDOWN_S = 0.25

#: How many replica-set members must durably apply a degraded write before
#: it is acknowledged (the coordinator's own apply counts as one).
WRITE_QUORUM = 2

#: Sentinel distinguishing "not cached" from a cached ``None``.
_MISS = object()

#: distinguishes lease holders across planes in one process (tests, benches)
_holder_seq = count()


class InvalidationBus:
    """Collaboration-wide pub/sub of metadata invalidations, keyed by path hash.

    Every mutating client publishes the path hashes it touched; every other
    subscribed cache drops matching entries.  The publisher's own caches are
    excluded (``origin`` — one cache or a collection, since a mount owns both
    an attribute cache and a data chunk cache) because they already hold the
    fresh state — that is what makes them write-back rather than read-only.

    Subscribers are duck-typed: anything with ``invalidate_hashes(hashes)``
    (:class:`AttrCache`, :class:`~repro_torch.core.datapath.ChunkCache`) rides the
    same fabric, so one publication keeps metadata *and* data reads fresh.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._caches: List[Any] = []
        self.published = 0

    def subscribe(self, cache: Any) -> None:
        with self._lock:
            if cache not in self._caches:
                self._caches.append(cache)

    def unsubscribe(self, cache: Any) -> None:
        with self._lock:
            if cache in self._caches:
                self._caches.remove(cache)

    def publish(self, hashes: Iterable[str], origin: Any = None) -> None:
        hashes = list(hashes)
        if not hashes:
            return
        if origin is None:
            excluded: Tuple[Any, ...] = ()
        elif isinstance(origin, (list, tuple, set, frozenset)):
            excluded = tuple(origin)
        else:
            excluded = (origin,)
        with self._lock:
            targets = [c for c in self._caches if not any(c is o for o in excluded)]
            self.published += len(hashes)
        for cache in targets:
            cache.invalidate_hashes(hashes)


class AttrCache:
    """LRU stat/attribute cache with path-hash-based invalidation.

    Entries are whole metadata rows (the dict ``getattr`` returns).  The
    secondary index maps ``path_hash`` → paths so an invalidation message —
    which carries only hashes, never full pathnames — can evict precisely.
    Dirty entries carry buffered ``update`` kwargs for write-back flushing.
    """

    def __init__(self, max_entries: int = 4096):
        self.max_entries = max_entries
        self._lock = threading.RLock()
        self._entries: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
        self._by_hash: Dict[str, set] = {}
        self._dirty: Dict[str, Dict[str, Any]] = {}
        self.hits = 0
        self.misses = 0
        self.invalidations = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def get(self, path: str) -> Any:
        with self._lock:
            entry = self._entries.get(path, _MISS)
            if entry is _MISS:
                self.misses += 1
                return _MISS
            self._entries.move_to_end(path)
            self.hits += 1
            return dict(entry)

    @staticmethod
    def is_miss(value: Any) -> bool:
        return value is _MISS

    def put(self, path: str, entry: Dict[str, Any]) -> None:
        with self._lock:
            self._entries[path] = dict(entry)
            self._entries.move_to_end(path)
            self._by_hash.setdefault(path_hash(path), set()).add(path)
            while len(self._entries) > self.max_entries:
                old_path, old_entry = self._entries.popitem(last=False)
                if old_path in self._dirty:
                    # never silently drop a buffered write — dirty entries pin
                    # the cache above its cap until flushed
                    self._entries[old_path] = old_entry
                    break
                self._unindex(old_path)

    def _unindex(self, path: str) -> None:
        bucket = self._by_hash.get(path_hash(path))
        if bucket is not None:
            bucket.discard(path)
            if not bucket:
                del self._by_hash[path_hash(path)]

    def pop(self, path: str) -> None:
        with self._lock:
            if self._entries.pop(path, None) is not None:
                self._unindex(path)
            self._dirty.pop(path, None)

    def invalidate_hashes(self, hashes: Iterable[str]) -> int:
        """Drop every entry whose pathname hashes to one of ``hashes``.

        Dirty entries are dropped too: a cross-client write to the same path
        supersedes our buffered update, and replaying it would clobber the
        newer row.
        """
        dropped = 0
        with self._lock:
            for h in hashes:
                for path in list(self._by_hash.get(h, ())):
                    self._entries.pop(path, None)
                    self._dirty.pop(path, None)
                    self._unindex(path)
                    dropped += 1
            self.invalidations += dropped
        return dropped

    # -- write-back bookkeeping ------------------------------------------------
    def mark_dirty(self, path: str, **update_kwargs: Any) -> None:
        with self._lock:
            pending = self._dirty.setdefault(path, {})
            pending.update(update_kwargs)
            entry = self._entries.get(path)
            if entry is not None:
                entry.update({k: v for k, v in update_kwargs.items() if k in entry})

    def dirty_paths(self) -> List[str]:
        with self._lock:
            return list(self._dirty)

    def take_dirty(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            dirty, self._dirty = self._dirty, {}
            return dirty

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "entries": len(self._entries),
                "dirty": len(self._dirty),
                "hits": self.hits,
                "misses": self.misses,
                "invalidations": self.invalidations,
            }


class CircuitBreaker:
    """Per-DTN failure gate: closed -> open -> half-open.

    ``threshold`` consecutive *unavailability* failures open the circuit;
    while open, :meth:`allow` denies calls instantly (no retry storms, no
    timeout sleeps against a peer known to be dead).  After ``cooldown_s``
    one probe call is let through (half-open): success closes the circuit,
    failure re-opens it for another cooldown.  Application-level errors
    (a method raising remotely) count as *success* — the peer answered.
    """

    def __init__(self, threshold: int = BREAKER_THRESHOLD, cooldown_s: float = BREAKER_COOLDOWN_S):
        self.threshold = max(1, threshold)
        self.cooldown_s = cooldown_s
        self.opened = 0  # open transitions (incl. re-opens), for observability
        self._failures = 0
        self._opened_at: Optional[float] = None
        self._probing = False
        self._lock = threading.Lock()

    @property
    def state(self) -> str:
        with self._lock:
            if self._opened_at is None:
                return "closed"
            if time.monotonic() - self._opened_at >= self.cooldown_s:
                return "half-open"
            return "open"

    def allow(self) -> bool:
        """May a call proceed right now?  (Half-open admits a single probe.)"""
        with self._lock:
            if self._opened_at is None:
                return True
            if time.monotonic() - self._opened_at < self.cooldown_s:
                return False
            if self._probing:
                return False
            self._probing = True
            return True

    def success(self) -> None:
        with self._lock:
            self._failures = 0
            self._opened_at = None
            self._probing = False

    def failure(self) -> None:
        with self._lock:
            reopening = self._probing  # a half-open probe just failed
            self._probing = False
            self._failures += 1
            if self._opened_at is not None or self._failures >= self.threshold:
                if self._opened_at is None or reopening:
                    self.opened += 1
                self._opened_at = time.monotonic()


class ServicePlane:
    """One client's gateway to every DTN's metadata + discovery service.

    ``max_inflight`` bounds how many DTNs a scatter contacts concurrently —
    the fan-out stays fixed as the collaboration grows, instead of spawning
    one thread per DTN per op.

    With a :class:`~repro_torch.core.rpc.RetryPolicy` every client retries
    unavailability with backoff + idempotency tokens; a per-DTN
    :class:`CircuitBreaker` (shared by the DTN's meta + sds clients) stops
    hammering a dead peer, and reads degrade to home-DC replicas
    (:meth:`stat`'s failover path) instead of failing while the origin is
    partitioned away.
    """

    def __init__(
        self,
        collab: "Collaboration",
        home_dc: str,
        *,
        max_inflight: int = 8,
        cache_entries: int = 4096,
        write_back: bool = False,
        subscribe: bool = True,
        journal_path: Optional[str] = None,
        wb_max_pending: int = WB_MAX_PENDING,
        wb_max_age_s: float = WB_MAX_AGE_S,
        prefer_replica: bool = False,
        summary_ttl_s: float = 0.0,
        retry: Optional[RetryPolicy] = None,
        breaker_threshold: int = BREAKER_THRESHOLD,
        breaker_cooldown_s: float = BREAKER_COOLDOWN_S,
        failover: bool = True,
        write_quorum: int = WRITE_QUORUM,
        lease_ttl_s: float = DEFAULT_LEASE_TTL_S,
        trace_enabled: Optional[bool] = None,
        trace_buffer_spans: Optional[int] = None,
        hist_buckets: Optional[int] = None,
    ):
        self.collab = collab
        self.home_dc = home_dc
        self.write_back = write_back
        self.prefer_replica = prefer_replica
        self.retry = retry
        #: degrade reads to home-DC replicas when the origin is unreachable
        #: (off = the fail-fast baseline fig13 measures against)
        self.failover = failover
        #: this plane's metrics registry + span buffer + tracer; unset knobs
        #: inherit the collaboration-wide defaults set by ``add_datacenter``
        ordinal = next(_holder_seq)
        self.telemetry = Telemetry(
            f"{home_dc}/plane{ordinal}",
            trace_enabled=(
                trace_enabled if trace_enabled is not None
                else getattr(collab, "trace_enabled", None)
            ),
            trace_buffer_spans=(
                trace_buffer_spans if trace_buffer_spans is not None
                else getattr(collab, "trace_buffer_spans", None)
            ),
            hist_buckets=(
                hist_buckets if hist_buckets is not None
                else getattr(collab, "hist_buckets", None)
            ),
        )
        register = getattr(collab, "register_telemetry", None)
        if register is not None:
            register(self.telemetry)
        # provider, not a snapshot: plans installed mid-run take effect on
        # the very next message, and None keeps the hot path overhead-free
        faults = lambda: getattr(collab, "fault_plan", None)  # noqa: E731
        tracer, registry = self.telemetry.tracer, self.telemetry.registry
        self.meta: List[RpcClient] = []
        self.sds: List[RpcClient] = []
        for dtn in collab.dtns:
            ch = collab.channel_policy(home_dc, dtn.dc_id)
            self.meta.append(
                RpcClient(dtn.metadata_server, ch, site=home_dc, retry=retry, faults=faults,
                          tracer=tracer, metrics=registry)
            )
            self.sds.append(
                RpcClient(dtn.discovery_server, ch, site=home_dc, retry=retry, faults=faults,
                          tracer=tracer, metrics=registry)
            )
        #: one breaker per DTN, shared by that DTN's meta + sds clients —
        #: a dead DTN takes both services with it
        self.breakers: List[CircuitBreaker] = [
            CircuitBreaker(breaker_threshold, breaker_cooldown_s) for _ in collab.dtns
        ]
        #: global indices of this client's home-DC DTNs (nearest replicas)
        self.local_dtns: List[int] = [
            i for i, dtn in enumerate(collab.dtns) if dtn.dc_id == home_dc
        ]
        self.cache = AttrCache(cache_entries)
        #: crash-recoverable buffer of deferred write-back updates; with a
        #: journal_path each deferred update is on disk before the write is
        #: acknowledged, and leftover records from a crashed predecessor are
        #: replayed into the dirty set here (committed on the next flush)
        def _journal_fault(frame_len: int) -> Optional[int]:
            plan = getattr(collab, "fault_plan", None)
            if plan is None:
                return None
            return plan.journal_torn_bytes(plan.next_journal_ordinal(), frame_len)

        self.journal = WriteBackJournal(
            journal_path,
            max_pending=wb_max_pending,
            max_age_s=wb_max_age_s,
            fault_hook=_journal_fault,
        )
        for path, kw in self.journal.recover().items():
            self.cache.mark_dirty(path, **kw)
        #: path -> witnessed-epoch fence for recovered (replayed) updates
        self._journal_fences: Dict[str, int] = self.journal.recovered_fences()
        self.replica_hits = 0
        self.replica_stale_fallbacks = 0
        #: degraded-mode accounting: reads served by replica failover while
        #: the origin was unreachable, of which stale_serves missed the
        #: session bar (explicitly flagged), and calls the breaker refused
        self.degraded_reads = 0
        self.stale_serves = 0
        self.breaker_skips = 0
        #: partition-tolerant writes: mutations accepted while the
        #: owner is unreachable, acknowledged only after ``write_quorum``
        #: replica-set members (coordinator included) durably applied them
        self.write_quorum = max(1, write_quorum)
        self.degraded_writes = 0
        self.quorum_acks = 0
        #: per-prefix epoch-fenced write leases; mutations issued under a
        #: lease carry its fencing token so a superseded holder is refused
        #: (RpcFenced) before the write can reach any replica log
        self.lease_manager = LeaseManager(
            holder=f"{home_dc}/plane{ordinal}",
            replica_set=lambda prefix: collab.replica_set(prefix),
            stand_ins=self._ring_rest,
            call=lambda idx, method, **kw: self.guarded_call("meta", idx, method, **kw),
            ttl_s=lease_ttl_s,
            tracer=tracer,
        )
        #: shard-pruning summary cache: dtn_idx -> (epoch, cached_at, summary).
        #: The authoritative pruning source is :meth:`note_summaries_bulk` —
        #: one query-time RPC to a local replica whose filters the
        #: replication stream keeps current, gated per origin on the
        #: replica's applied map meeting this client's session bar (the same
        #: bar replica reads use).  The cache only *reuses* those results
        #: across queries when ``summary_ttl_s > 0``: a cached filter cannot
        #: see server-side indexing this client never witnessed (async
        #: drains, other collaborators), so reuse trades a TTL-bounded
        #: recall window for the warm RPC — off by default.
        self.summary_ttl_s = summary_ttl_s
        self._summaries: Dict[int, Tuple[int, float, ShardSummary]] = {}
        self.shard_contacts = 0
        self.shards_pruned = 0
        self.pruned_empty_queries = 0
        #: sibling caches owned by the same mount (e.g. the data plane's
        #: chunk cache): excluded from our own publications alongside the
        #: attr cache, because the mount updates them in place on its writes
        self._co_caches: List[Any] = []
        self._bus: Optional[InvalidationBus] = getattr(collab, "invalidations", None)
        # write-only clients (MEU) publish invalidations but never read
        # through their cache, so they skip the subscription — otherwise every
        # throwaway exporter would pin a dead cache on the bus for the
        # collaboration's lifetime.
        if self._bus is not None and subscribe:
            self._bus.subscribe(self.cache)
        self.max_inflight = max(1, max_inflight)
        self._closed = False
        # scrape-time collectors: the registry *pulls* the live counters, so
        # resilience_stats()/rpc_stats() become shims over one fold and the
        # hand-merged-keys drift hazard is gone
        self.telemetry.add_collector("rpc", self.rpc_stats)
        self.telemetry.add_collector("plane", self._plane_stats)
        self.telemetry.add_collector("attrcache", self.cache.stats)
        self.telemetry.add_collector("lease", self.lease_manager.stats)

    def _plane_stats(self) -> Dict[str, Any]:
        """This plane's own counters (degraded serves, breakers, quorum
        writes, shard pruning) under the ``plane.`` metric prefix."""
        return {
            "replica_hits": self.replica_hits,
            "replica_stale_fallbacks": self.replica_stale_fallbacks,
            "degraded_reads": self.degraded_reads,
            "stale_serves": self.stale_serves,
            "breaker_skips": self.breaker_skips,
            "breakers_opened": sum(b.opened for b in self.breakers),
            "degraded_writes": self.degraded_writes,
            "quorum_acks": self.quorum_acks,
            "shard_contacts": self.shard_contacts,
            "shards_pruned": self.shards_pruned,
            "pruned_empty_queries": self.pruned_empty_queries,
        }

    def telemetry_fold(self) -> Dict[str, Any]:
        """This plane's registry folded with the fabric's
        :meth:`~repro_torch.core.cluster.Collaboration.observe` scrape — every
        counter one mount can see, flat, under hierarchical dotted names."""
        snaps = [self.telemetry.snapshot()]
        observe = getattr(self.collab, "observe", None)
        if observe is not None:
            snaps.append(observe())
        return fold_snapshots(snaps)

    # -- placement ------------------------------------------------------------
    def n_dtns(self) -> int:
        return len(self.meta)

    def owner(self, path: str) -> int:
        return hash_placement(path, len(self.collab.dtns))

    def _clients(self, service: str) -> List[RpcClient]:
        if service == "meta":
            return self.meta
        if service == "sds":
            return self.sds
        raise ValueError(f"unknown service {service!r} (want 'meta' or 'sds')")

    def clients(self) -> List[RpcClient]:
        """Every RPC client this plane owns (both services), for accounting."""
        return self.meta + self.sds

    # -- single + batched calls ------------------------------------------------
    def call(self, service: str, dtn_idx: int, method: str, **kwargs: Any) -> Any:
        return self._clients(service)[dtn_idx].call(method, **kwargs)

    def batch(
        self,
        service: str,
        dtn_idx: int,
        calls: Sequence[Tuple[str, Dict[str, Any]]],
        *,
        return_exceptions: bool = False,
    ) -> List[Any]:
        return self._clients(service)[dtn_idx].call_batch(
            calls, return_exceptions=return_exceptions
        )

    def meta_call(self, dtn_idx: int, method: str, **kwargs: Any) -> Any:
        return self.call("meta", dtn_idx, method, **kwargs)

    def meta_batch(self, dtn_idx: int, calls, **kw) -> List[Any]:
        return self.batch("meta", dtn_idx, calls, **kw)

    def sds_call(self, dtn_idx: int, method: str, **kwargs: Any) -> Any:
        return self.call("sds", dtn_idx, method, **kwargs)

    def sds_batch(self, dtn_idx: int, calls, **kw) -> List[Any]:
        return self.batch("sds", dtn_idx, calls, **kw)

    # -- circuit-breaker-guarded calls ------------------------------------------
    def _breaker_check(self, dtn_idx: int) -> None:
        if not self.breakers[dtn_idx].allow():
            self.breaker_skips += 1
            # an open circuit refuses without touching the wire, so no RPC
            # span exists — record the refusal itself when inside a trace
            tracer = self.telemetry.tracer
            if tracer.enabled and tracer.current() is not None:
                tracer.record("breaker.skip", status="unavailable", tags={"dtn": dtn_idx})
            raise RpcUnavailable(f"dtn{dtn_idx}: circuit open")

    def guarded_call(self, service: str, dtn_idx: int, method: str, **kwargs: Any) -> Any:
        """:meth:`call` through the DTN's circuit breaker: an open circuit
        fails instantly with :class:`RpcUnavailable` (no timeouts, no retry
        storm against a dead peer); outcomes feed the breaker state."""
        self._breaker_check(dtn_idx)
        breaker = self.breakers[dtn_idx]
        try:
            result = self.call(service, dtn_idx, method, **kwargs)
        except RpcUnavailable:
            breaker.failure()
            raise
        except RpcError:
            breaker.success()  # the peer answered; the *application* failed
            raise
        breaker.success()
        return result

    def fenced_call(
        self, service: str, dtn_idx: int, fence: Dict[str, Any], method: str, **kwargs: Any
    ) -> Any:
        """:meth:`guarded_call` with a lease's fencing token on the envelope.

        The receiving DTN admits the call only if ``fence["token"]`` is at or
        above its fence floor for the prefix (:class:`~repro_torch.core.leases.LeaseTable`);
        a superseded holder gets :class:`~repro_torch.core.rpc.RpcFenced` — which
        counts as breaker *success* (the peer answered) and is never retried.
        """
        self._breaker_check(dtn_idx)
        breaker = self.breakers[dtn_idx]
        try:
            result = self._clients(service)[dtn_idx].call_fenced(fence, method, **kwargs)
        except RpcUnavailable:
            breaker.failure()
            raise
        except RpcError:  # includes RpcFenced: an answer, not an outage
            breaker.success()
            raise
        breaker.success()
        return result

    # -- partition-tolerant (quorum-acknowledged) mutations ---------------------
    def write_lease(self, prefix: str) -> Lease:
        """A live epoch-fenced write lease on ``prefix`` (acquire/renew)."""
        return self.lease_manager.hold(prefix)

    def _ring_rest(self, prefix: str) -> List[int]:
        """Ring successors beyond the prefix's replica set — the hinted
        stand-in extension of the preference list (Dynamo-style)."""
        total = len(self.collab.dtns)
        members = set(self.collab.replica_set(prefix))
        owner = hash_placement(prefix, total)
        return [
            (owner + k) % total
            for k in range(total)
            if (owner + k) % total not in members
        ]

    def _quorum_targets(self, prefix: str, lease: Lease) -> List[int]:
        """Candidate appliers for a degraded write, most-preferred first.

        The lease's *grant set* leads: those DTNs minted/witnessed the
        lease's token, so their fence floors are raised — a stale holder is
        refused at the first contact.  The remaining replica-set members and
        ring stand-ins follow for quorum top-up under partial faults.
        """
        members = self.collab.replica_set(prefix)
        granted = list(lease.grants)
        rest = [i for i in members if i not in granted] + [
            i for i in self._ring_rest(prefix) if i not in granted
        ]
        return granted + rest

    def quorum_create(
        self, path: str, create_kwargs: Dict[str, Any], *, prefix: Optional[str] = None
    ) -> Dict[str, Any]:
        """Accept a ``create`` while the path's owner is unreachable.

        The partition-tolerant write path: acquire the prefix's
        epoch-fenced lease, journal the intent (fsync-before-ack when the
        journal is on disk), have a reachable *coordinator* perform the
        create in origin role — it ticks its own clock and appends to its
        own replication log, so the record converges everywhere (including
        the healed owner) through the ordinary pump — then push the stamped
        row directly to further targets until ``write_quorum`` members have
        durably applied it.  Only then is the intent acknowledged
        (``journal.ack``).  Every RPC carries the lease's fencing token: a
        stale holder is refused (:class:`~repro_torch.core.rpc.RpcFenced`) before
        its write can touch any service or replication log.

        Raises :class:`~repro_torch.core.leases.LeaseUnavailable` /
        :class:`LeaseHeldElsewhere` when no lease can be held, and
        :class:`RpcUnavailable` when fewer than ``write_quorum`` targets are
        reachable — an unacknowledged write (the journal keeps the intent).

        The whole degraded path runs under one ``plane.quorum_create`` span
        (status ``degraded`` on success): lease fan-out, journal intent,
        coordinator create and quorum pushes all land in the same trace, and
        the span is registered with the collaboration
        (:meth:`~repro_torch.core.cluster.Collaboration.link_trace`) so the
        heal-time reconcile joins it as the final causal step.
        """
        prefix = prefix if prefix is not None else (path.rsplit("/", 1)[0] or "/")
        tracer = self.telemetry.tracer
        with tracer.span("plane.quorum_create", path=path) as sp:
            result = self._quorum_create(path, create_kwargs, prefix)
            if sp is not None:
                sp.status = "degraded"
                sp.tags.update(acks=result["acks"], coordinator=result["coordinator"])
                link = getattr(self.collab, "link_trace", None)
                if link is not None:
                    link(prefix, (sp.trace_id, sp.span_id))
            return result

    def _quorum_create(
        self, path: str, create_kwargs: Dict[str, Any], prefix: str
    ) -> Dict[str, Any]:
        lease = self.write_lease(prefix)
        fence = lease.fence()
        journal_kw = {
            k: create_kwargs[k] for k in ("size", "sync") if k in create_kwargs
        }
        with self.telemetry.tracer.span("journal.intent", path=path):
            self.journal.append(
                path, journal_kw, epoch=self.seen_epoch(self.owner(path))
            )
        self._journal_fences.pop(path, None)
        targets = self._quorum_targets(prefix, lease)
        entry: Optional[Dict[str, Any]] = None
        coordinator: Optional[int] = None
        for idx in targets:
            try:
                entry = self.fenced_call("meta", idx, fence, "create", **create_kwargs)
                coordinator = idx
                break
            except RpcFenced:
                self.journal.ack(path)  # refused, not lost: drop the intent
                raise
            except RpcUnavailable:
                continue
        if entry is None or coordinator is None:
            self.journal.ack(path)  # nothing was created anywhere
            raise RpcUnavailable(
                f"degraded create {path!r}: no replica-set member reachable"
            )
        record = {
            "service": "meta",
            "op": "upsert",
            "entries": [dict(entry)],
            "epoch": int(entry["epoch"]),
            "origin": int(entry["origin"]),
            # wm=0: a direct push must not inflate the target's applied
            # watermark for the coordinator — the pump still owes history
            "wm": 0,
        }
        acks = 1  # the coordinator's own durable apply
        for idx in targets:
            if acks >= self.write_quorum:
                break
            if idx == coordinator:
                continue
            try:
                self.fenced_call(
                    "meta", idx, fence, "apply_replicated", records=[dict(record)]
                )
            except RpcFenced:
                raise
            except RpcUnavailable:
                continue
            acks += 1
        if acks < self.write_quorum:
            # NOT acknowledged: the journal keeps the intent, the coordinator's
            # log will still converge the partial state, and the caller may
            # retry (idempotency tokens make the retry exactly-once)
            raise RpcUnavailable(
                f"degraded create {path!r}: {acks}/{self.write_quorum} quorum acks"
            )
        self.journal.ack(path)
        self.degraded_writes += 1
        self.quorum_acks += acks
        return {
            "entry": entry,
            "acks": acks,
            "quorum": self.write_quorum,
            "coordinator": coordinator,
            "degraded": True,
            "lease_degraded": lease.degraded,
            "token": lease.token,
        }

    # -- scatter-gather --------------------------------------------------------
    def _pay_windows(self, delays: List[float]) -> None:
        """Sleep the makespan of a bounded-concurrency fan-out.

        Links inside one ``max_inflight`` window overlap (cost = the slowest
        member); windows run back-to-back.  The serialization + service CPU
        was already paid for real while the calls executed inline.
        """
        total = 0.0
        for i in range(0, len(delays), self.max_inflight):
            window = delays[i : i + self.max_inflight]
            if window:
                total += max(window)
        if total > 0:
            time.sleep(total)

    def scatter(
        self,
        service: str,
        method: str,
        kwargs: Optional[Dict[str, Any]] = None,
        *,
        per_dtn_kwargs: Optional[Dict[int, Dict[str, Any]]] = None,
    ) -> List[Any]:
        """Fan one method out to DTNs with bounded concurrency; gather in order.

        With ``kwargs`` every DTN receives the same arguments; with
        ``per_dtn_kwargs`` only the listed DTNs are contacted and the result
        list carries ``None`` in the skipped slots.
        """
        clients = self._clients(service)
        if per_dtn_kwargs is None:
            targets = {i: (kwargs or {}) for i in range(len(clients))}
        else:
            targets = per_dtn_kwargs
        results: List[Any] = [None] * len(clients)
        delays: List[float] = []
        for i in sorted(targets):
            self._breaker_check(i)
            try:
                results[i], wire = clients[i].call_deferred(method, **targets[i])
            except RpcUnavailable:
                self.breakers[i].failure()
                raise
            self.breakers[i].success()
            delays.append(wire)
        self._pay_windows(delays)
        return results

    def scatter_batch(
        self,
        service: str,
        calls_by_dtn: Dict[int, Sequence[Tuple[str, Dict[str, Any]]]],
        *,
        return_exceptions: bool = False,
    ) -> Dict[int, List[Any]]:
        """One batched round-trip per DTN, all DTN windows in flight at once."""
        clients = self._clients(service)
        out: Dict[int, List[Any]] = {}
        delays: List[float] = []
        for i in sorted(calls_by_dtn):
            calls = calls_by_dtn[i]
            if not calls:
                continue
            self._breaker_check(i)
            try:
                out[i], wire = clients[i].call_batch_deferred(
                    calls, return_exceptions=return_exceptions
                )
            except RpcUnavailable:
                self.breakers[i].failure()
                raise
            self.breakers[i].success()
            delays.append(wire)
        self._pay_windows(delays)
        return out

    # -- epoch accounting ------------------------------------------------------
    def seen_epoch(self, dtn_idx: int) -> int:
        """Highest epoch this client has witnessed from a DTN's envelopes —
        the session-consistency bar a replica must meet to serve its rows."""
        return max(self.meta[dtn_idx].last_epoch, self.sds[dtn_idx].last_epoch)

    def seen_epochs(self) -> Dict[int, int]:
        return {i: self.seen_epoch(i) for i in range(len(self.meta))}

    def _nearest_replica(self, path: str) -> Optional[int]:
        """A home-DC DTN to serve this path's replica row (spread by hash)."""
        if not self.local_dtns:
            return None
        return self.local_dtns[hash_placement(path, len(self.local_dtns))]

    # -- shard summaries -------------------------------------------------------
    def note_summary(self, dtn_idx: int, reply: Any) -> None:
        """Harvest the piggybacked shard summary from a ``scatter_query`` reply.

        Summaries ride every discovery reply for free (no extra RPC); newer
        epochs replace older cached copies, and equal epochs refresh the TTL.
        """
        if not isinstance(reply, dict):
            return
        msg = reply.get("summary")
        if not isinstance(msg, dict):
            return
        epoch = int(reply.get("summary_epoch", 0))
        cached = self._summaries.get(dtn_idx)
        if cached is not None and cached[0] > epoch:
            return
        try:
            summary = ShardSummary.from_message(msg)
        except (KeyError, TypeError, ValueError):
            return
        self._summaries[dtn_idx] = (epoch, time.monotonic(), summary)

    def note_summaries_bulk(self, reply: Any) -> Dict[int, ShardSummary]:
        """Ingest a ``summaries`` RPC reply (own + replicated peer filters).

        Returns the filters that are usable for pruning *right now*.  A
        replica's copy of origin *S*'s filter is complete through
        ``max(filter epoch, applied[S])`` (every record it applies from S is
        folded in), so it may prune S only when that bound covers every
        epoch this client has witnessed from S — the session-consistency
        bar.  The serving DTN's own filter is judged the same way against
        its own epoch.  Usable filters also land in the TTL cache.
        """
        if not isinstance(reply, dict):
            return {}
        usable: Dict[int, ShardSummary] = {}
        applied = {int(k): int(v) for k, v in (reply.get("applied") or {}).items()}
        now = time.monotonic()
        for origin_s, msg in (reply.get("summaries") or {}).items():
            try:
                origin = int(origin_s)
                epoch = int(msg.get("epoch", 0))
                summary = ShardSummary.from_message(msg)
            except (AttributeError, KeyError, TypeError, ValueError):
                continue
            if origin < 0 or origin >= len(self.sds):
                continue
            complete_through = max(epoch, applied.get(origin, 0))
            if complete_through < self.seen_epoch(origin):
                continue  # session bar not met: this filter may miss our writes
            usable[origin] = summary
            cached = self._summaries.get(origin)
            if cached is None or cached[0] <= complete_through:
                self._summaries[origin] = (complete_through, now, summary)
        return usable

    def fresh_summaries(self) -> Dict[int, ShardSummary]:
        """TTL-cache reuse of previously ingested filters (see ``_summaries``).

        Empty unless ``summary_ttl_s > 0`` — cached filters are blind to
        server-side indexing this client never witnessed, so cross-query
        reuse is an explicit opt-in with a TTL-bounded recall window.
        """
        if self.summary_ttl_s <= 0:
            return {}
        now = time.monotonic()
        fresh: Dict[int, ShardSummary] = {}
        for idx, (epoch, cached_at, summary) in self._summaries.items():
            if epoch >= self.seen_epoch(idx) and now - cached_at <= self.summary_ttl_s:
                fresh[idx] = summary
        return fresh

    # -- cached metadata surface ----------------------------------------------
    def stat(self, path: str) -> Optional[Dict[str, Any]]:
        """Cache-first getattr.  A hit is zero RPCs; a miss fills the cache.

        With ``prefer_replica`` (and the collaboration's replication tier
        running) a path owned by a remote-DC DTN is read from the nearest
        home-DC replica instead — one intra-DC round-trip instead of a
        cross-DC one.  The replica serves only when it has applied every
        epoch this client has witnessed from the origin (session
        consistency: your own acknowledged writes are always re-readable);
        otherwise the read falls back to the origin.  Replica-served rows
        carry a ``"replica"`` tag with the serving DTN and its applied/lag
        accounting — cached rows stay untagged.
        """
        cached = self.cache.get(path)
        if not AttrCache.is_miss(cached):
            return cached
        owner = self.owner(path)
        if (
            self.prefer_replica
            and owner not in self.local_dtns
            and getattr(self.collab, "replication_enabled", False)
        ):
            nearest = self._nearest_replica(path)
            if nearest is not None:
                try:
                    rep = self.guarded_call(
                        "meta", nearest, "getattr_replica", path=path, origin=owner
                    )
                except RpcUnavailable:
                    rep = None  # nearest replica itself is down: try the origin
                bar = self.seen_epoch(owner)
                entry = rep.get("entry") if rep is not None else None
                # a missing row is never provably fresh — only positive hits
                # that meet the session bar are served from the replica
                if entry is not None and rep.get("applied", 0) >= bar:
                    self.replica_hits += 1
                    self.cache.put(path, entry)
                    tagged = dict(entry)
                    tagged["replica"] = {
                        "dtn": nearest,
                        "applied": rep.get("applied", 0),
                        "behind": max(0, bar - rep.get("applied", 0)),
                    }
                    return tagged
                self.replica_stale_fallbacks += 1
        try:
            entry = self.guarded_call("meta", owner, "getattr", path=path)
        except RpcUnavailable:
            # the origin is unreachable (crashed DTN, partitioned link, open
            # breaker): degrade to the replica tier instead of failing
            return self._degraded_stat(path, owner)
        if entry is not None:
            self.cache.put(path, entry)
        return entry

    def _degraded_stat(self, path: str, owner: int) -> Optional[Dict[str, Any]]:
        """Replica failover for :meth:`stat` while the origin is unreachable.

        Serves the row from a home-DC replica when one has applied every
        epoch this client witnessed from the origin (the same session bar
        ``prefer_replica`` reads use).  When even the best replica lags the
        bar, the row is still served — availability over freshness during a
        partition — but explicitly flagged ``stale`` (and *not* cached, so a
        healed origin is consulted again).  A bar-meeting replica that has
        no row proves the path absent.  With no reachable replica (or
        ``failover=False``, the fail-fast baseline) the original
        unavailability propagates.
        """
        if not self.failover or not getattr(self.collab, "replication_enabled", False):
            raise RpcUnavailable(f"dtn{owner} unreachable and failover disabled")
        candidates = [i for i in self.local_dtns if i != owner]
        start = self._nearest_replica(path)
        if start in candidates:  # rotate so load spreads like prefer_replica's
            k = candidates.index(start)
            candidates = candidates[k:] + candidates[:k]
        bar = self.seen_epoch(owner)
        best: Optional[Tuple[int, int, Dict[str, Any]]] = None  # (applied, dtn, entry)
        absent_proven = False
        for idx in candidates:
            try:
                rep = self.guarded_call(
                    "meta", idx, "getattr_replica", path=path, origin=owner
                )
            except RpcUnavailable:
                continue
            applied = int(rep.get("applied", 0))
            entry = rep.get("entry")
            if applied >= bar:
                if entry is None:
                    absent_proven = True
                    continue
                self.degraded_reads += 1
                self.cache.put(path, entry)
                tagged = dict(entry)
                tagged["replica"] = {"dtn": idx, "applied": applied, "behind": 0}
                tagged["degraded"] = True
                return tagged
            if entry is not None and (best is None or applied > best[0]):
                best = (applied, idx, entry)
        if best is not None:
            applied, idx, entry = best
            self.degraded_reads += 1
            self.stale_serves += 1
            tagged = dict(entry)  # NOT cached: a stale row must not stick
            tagged["replica"] = {"dtn": idx, "applied": applied, "behind": bar - applied}
            tagged["degraded"] = True
            tagged["stale"] = True
            return tagged
        if absent_proven:
            self.degraded_reads += 1
            return None
        raise RpcUnavailable(
            f"dtn{owner} unreachable and no home-DC replica could serve {path!r}"
        )

    def note_entry(self, entry: Dict[str, Any]) -> None:
        """Record a row this client just wrote; evict it everywhere else."""
        path = entry["path"]
        self.cache.put(path, entry)
        self.publish([path])

    def note_remove(self, path: str) -> None:
        self.cache.pop(path)
        self.publish([path])

    def attach_cache(self, cache: Any) -> None:
        """Register a sibling cache of this mount (chunk cache) so our own
        publications do not evict its freshly written-through entries."""
        if cache is not None and not any(c is cache for c in self._co_caches):
            self._co_caches.append(cache)

    def publish(self, paths: Iterable[str]) -> None:
        if self._bus is not None:
            self._bus.publish(
                [path_hash(p) for p in paths], origin=(self.cache, *self._co_caches)
            )

    # -- write-back ------------------------------------------------------------
    def defer_update(self, path: str, **update_kwargs: Any) -> None:
        """Buffer a metadata ``update`` (the five-op 'flush') for later commit.

        The update is journaled (durably, when the journal is on disk)
        *before* this returns — that is the acknowledgement point — then the
        journal's count/age thresholds decide whether to flush now.
        """
        self.journal.append(path, update_kwargs, epoch=self.seen_epoch(self.owner(path)))
        # a live deferred update supersedes any fence recovered for this path
        # from a crashed predecessor — fencing it would drop OUR acknowledged
        # write whenever another client has since touched the row
        self._journal_fences.pop(path, None)
        self.cache.mark_dirty(path, **update_kwargs)
        if self.journal.should_flush():
            self.flush()

    def maybe_flush(self) -> int:
        """Flush iff a write-back threshold (count/age) has fired."""
        return self.flush() if self.journal.should_flush() else 0

    def flush(self) -> int:
        """Commit buffered updates: one batched ``update`` per owner DTN."""
        dirty = self.cache.take_dirty()
        # the journal may hold more than the cache: entries evicted by
        # cross-client invalidation (superseded — replaying them would
        # clobber newer rows, so the journal follows the cache's dirty set)
        if not dirty:
            self.journal.mark_flushed()
            return 0
        calls_by_dtn: Dict[int, List[Tuple[str, Dict[str, Any]]]] = {}
        for path, kw in dirty.items():
            if path in self._journal_fences:
                # recovered from a crashed predecessor: fence the update so a
                # newer cross-client row (whose invalidation the dead process
                # never saw) wins at the origin instead of being clobbered
                kw = dict(kw, fence_epoch=self._journal_fences[path])
            calls_by_dtn.setdefault(self.owner(path), []).append(
                ("update", dict(kw, path=path))
            )
        try:
            self.scatter_batch("meta", calls_by_dtn)
        except RpcError:
            # an acknowledged update must survive a failed commit: restore
            # the dirty set (the journal still holds every record) and let a
            # later flush retry — re-sends are idempotent at the origin
            for path, kw in dirty.items():
                self.cache.mark_dirty(path, **kw)
            raise
        self._journal_fences = {}
        self.journal.mark_flushed()
        self.publish(list(dirty))
        return len(dirty)

    # -- accounting / lifecycle -------------------------------------------------
    def resilience_stats(self) -> Dict[str, Any]:
        """Fault-plane accounting: degraded serves, breaker activity, retry
        budget exhaustion, server-side dedup pressure, and the quorum/lease
        write path.

        Deprecated in favor of :meth:`telemetry_fold` /
        ``Workspace.telemetry()``: this is now a *shim* that reads the same
        registry fold and maps it back to the historical key names, so the
        two surfaces can never drift apart again.  ``breaker_states`` stays
        a direct point-in-time read (a state list, not a counter).
        """
        fold = self.telemetry_fold()
        return {
            "degraded_reads": fold.get("plane.degraded_reads", 0),
            "stale_serves": fold.get("plane.stale_serves", 0),
            "breaker_skips": fold.get("plane.breaker_skips", 0),
            "breakers_opened": fold.get("plane.breakers_opened", 0),
            "breaker_states": [b.state for b in self.breakers],
            # give-ups caused specifically by an exhausted shared retry budget
            # (not per-call attempts) — distinguishes "the budget starved us"
            # from "the peer was just down"
            "budget_exhausted": fold.get("rpc.budget_exhausted", 0),
            # server-side idempotency-window evictions: >0 means replies were
            # aged out and a late retry could re-execute — the knob to watch
            # when sizing dedup_window
            "dedup_evictions": fold.get("rpc.dedup_evictions", 0),
            "fenced_rejections": fold.get("rpc.fenced_rejections", 0),
            "degraded_writes": fold.get("plane.degraded_writes", 0),
            "quorum_acks": fold.get("plane.quorum_acks", 0),
            "leases": {
                k: fold.get(f"lease.{k}", 0)
                for k in ("acquired", "degraded_acquired", "renewed", "held")
            },
        }

    def rpc_stats(self) -> Dict[str, float]:
        """Sum of every owned client's :class:`~repro_torch.core.rpc.RpcStats` —
        also the source the registry's ``rpc.*`` collector pulls from."""
        agg: Dict[str, float] = {}
        for client in self.meta + self.sds:
            for k, v in client.stats.snapshot().items():
                agg[k] = agg.get(k, 0) + v
        return agg

    def crash(self) -> None:
        """Simulate client death: nothing is flushed, the journal file (if
        any) keeps its records for a successor plane to recover."""
        if self._closed:
            return
        self._closed = True
        self.journal.close()
        if self._bus is not None:
            self._bus.unsubscribe(self.cache)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            self.lease_manager.release_all()
        except RpcError:
            pass  # unreleased leases simply expire at their TTL
        try:
            self.flush()
        except RpcError:
            pass  # best-effort: the services may already be gone at teardown
        self.journal.close()
        if self._bus is not None:
            self._bus.unsubscribe(self.cache)
