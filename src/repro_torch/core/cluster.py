"""Testbed assembly: data centers, DTNs, and the collaboration fabric.

Mirrors the paper's evaluation setup (§IV-B, Table I): N geo-distributed data
centers, each with a PFS (a :class:`~repro_torch.core.backends.StorageBackend`) and
a set of DTNs that are (a) clients of the local PFS and (b) hosts of the
metadata + discovery service shards.  Collaborator machines mount the
workspace over *all* DTNs of *all* data centers.

In the TPU-fleet adaptation (DESIGN.md §2) a :class:`DataCenter` is a pod and
its DTNs are the pod's I/O host group; the cross-DC channel is the DCN.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from .backends import MemoryBackend, PosixBackend, StorageBackend
from .discovery import AsyncIndexer, DiscoveryService
from .leases import LeaseTable
from .metadata import DiscoveryShard, MetadataService, MetadataShard, hash_placement
from .namespace import NamespaceRegistry
from .plane import InvalidationBus
from .replication import (
    RECONCILE_TIMEOUT_S,
    AntiEntropyReconciler,
    AppliedMap,
    EpochClock,
    ReplicaPump,
    ReplicationLog,
)
from .rpc import Channel, RpcServer
from .telemetry import Telemetry, assemble_trace, fold_snapshots

__all__ = ["DTN", "DataCenter", "Collaboration", "ChannelPolicy", "REPLICA_N"]

#: default size of a path's replica set (owner + ring successors) — the N of
#: "W of N" quorum writes; configs/scispace_testbed.py re-exports this
REPLICA_N = 3


def _drop_ids(stats: Dict) -> Dict:
    """Strip identity fields (dtn_id) that must not sum across a fold."""
    return {k: v for k, v in stats.items() if k != "dtn_id"}


class DTN:
    """A data transfer node: PFS client + one metadata shard + one discovery shard.

    Each DTN carries one Lamport :class:`EpochClock` (shared by both services
    and stamped on every RPC envelope) and one append-only
    :class:`ReplicationLog` that both services feed; a :class:`ReplicaPump`
    (started by :meth:`Collaboration.start_replication`) drains the log to
    every peer DTN asynchronously.
    """

    def __init__(
        self,
        dtn_id: int,
        dc_id: str,
        backend: StorageBackend,
        db_dir: Optional[str],
        summary_bits: Optional[int] = None,
        trace_enabled: Optional[bool] = None,
        trace_buffer_spans: Optional[int] = None,
        hist_buckets: Optional[int] = None,
    ):
        self.dtn_id = dtn_id
        self.dc_id = dc_id
        self.backend = backend
        #: this node's metrics registry + span buffer; both RPC servers record
        #: server-side spans into it and ``Collaboration.observe()`` folds it
        self.telemetry = Telemetry(
            f"dtn{dtn_id}@{dc_id}",
            trace_enabled=trace_enabled,
            trace_buffer_spans=trace_buffer_spans,
            hist_buckets=hist_buckets,
        )
        if db_dir is None:
            meta_db = disc_db = ":memory:"
        else:
            meta_db = os.path.join(db_dir, f"dtn{dtn_id}_meta.db")
            disc_db = os.path.join(db_dir, f"dtn{dtn_id}_disc.db")
        self.clock = EpochClock()
        self.replication_log = ReplicationLog()
        self.applied = AppliedMap()
        self.mutation_lock = threading.RLock()
        self.metadata_shard = MetadataShard(meta_db)
        self.discovery_shard = DiscoveryShard(disc_db)
        #: write-lease grants + fence floors; shared by both RPC servers so a
        #: single floor governs every mutating envelope this DTN admits
        self.leases = LeaseTable(self.clock)
        self.metadata = MetadataService(
            self.metadata_shard, dtn_id=dtn_id, dc_id=dc_id,
            clock=self.clock, log=self.replication_log, applied=self.applied,
            mutation_lock=self.mutation_lock, leases=self.leases,
        )
        disc_kwargs: dict = {}
        if summary_bits is not None:
            disc_kwargs["summary_bits"] = summary_bits
        self.discovery = DiscoveryService(
            self.discovery_shard, dtn_id=dtn_id, backend=backend,
            clock=self.clock, log=self.replication_log, applied=self.applied,
            mutation_lock=self.mutation_lock, **disc_kwargs,
        )
        self.metadata_server = RpcServer(
            self.metadata, name=f"meta@dtn{dtn_id}", clock=self.clock, site=dc_id,
            fences=self.leases, telemetry=self.telemetry,
        )
        self.discovery_server = RpcServer(
            self.discovery, name=f"sds@dtn{dtn_id}", clock=self.clock, site=dc_id,
            fences=self.leases, telemetry=self.telemetry,
        )
        self.async_indexer: Optional[AsyncIndexer] = None
        self.replica_pump: Optional[ReplicaPump] = None
        self._indexer_kwargs: Optional[dict] = None
        # fold this node's pre-existing stats() surfaces into the registry at
        # scrape time (one source of truth per counter, no hand-merged dicts)
        tel = self.telemetry
        tel.add_collector("rpc", self._server_stats)
        tel.add_collector("lease", self.leases.stats)
        tel.add_collector("meta", lambda: _drop_ids(self.metadata.stats()))
        tel.add_collector("sds", lambda: _drop_ids(self.discovery.stats()))
        tel.add_collector("replication", self._pump_stats)

    def _server_stats(self) -> Dict[str, int]:
        ms, ds = self.metadata_server, self.discovery_server
        return {
            "requests": ms.requests + ds.requests,
            "deduped": ms.deduped + ds.deduped,
            "dedup_evictions": ms.dedup_evictions + ds.dedup_evictions,
            "fenced_rejections": ms.fenced_rejections + ds.fenced_rejections,
        }

    def _pump_stats(self) -> Dict[str, float]:
        pump = self.replica_pump
        return _drop_ids(pump.stats()) if pump is not None else {}

    def start_async_indexer(self, **kwargs) -> AsyncIndexer:
        if self.async_indexer is None:
            self._indexer_kwargs = dict(kwargs)
            if self.down:
                # deferred: restart() builds the indexer from the saved
                # kwargs — a crashed DTN must not run background workers
                return None  # type: ignore[return-value]
            self.async_indexer = AsyncIndexer(self.discovery, **kwargs).start()
        return self.async_indexer

    @property
    def down(self) -> bool:
        return self.metadata_server.down

    def crash(self) -> None:
        """Simulate a DTN crash/partition: both services become unreachable
        and the background workers die without draining.  Shard state is the
        durable half (SQLite); in-flight queues and pump cursors survive in
        this in-process simulation the way an fsync'd store would."""
        self.metadata_server.down = True
        self.discovery_server.down = True
        if self.async_indexer is not None:
            self.async_indexer.stop(drain=False)
            self.async_indexer = None
        if self.replica_pump is not None:
            self.replica_pump.stop(drain=False)

    def restart(self) -> None:
        """Bring a crashed DTN back.  Peers' pumps still hold their cursors,
        so every record this DTN missed while down is re-shipped by the
        normal drain path — recovery needs no special-case protocol.

        The pump restarts here even when ``start_replication`` ran *while
        this DTN was down* (it creates the pump but cannot start it on a dead
        node) — the node rejoins the mesh without a second
        ``start_replication`` call.
        """
        self.metadata_server.down = False
        self.discovery_server.down = False
        if self.async_indexer is None and self._indexer_kwargs is not None:
            self.async_indexer = AsyncIndexer(self.discovery, **self._indexer_kwargs).start()
        if self.replica_pump is not None:
            self.replica_pump.start()

    def stop(self) -> None:
        if self.async_indexer is not None:
            self.async_indexer.stop()
            self.async_indexer = None
        if self.replica_pump is not None:
            self.replica_pump.stop()

    def close(self) -> None:
        self.stop()
        self.metadata_shard.close()
        self.discovery_shard.close()


class DataCenter:
    """One HPC data center: a PFS namespace + its DTNs."""

    def __init__(self, dc_id: str, backend: StorageBackend):
        self.dc_id = dc_id
        self.backend = backend
        self.dtns: List[DTN] = []

    def local_dtns(self) -> List[DTN]:
        return self.dtns

    def has_live_dtn(self) -> bool:
        """True while at least one DTN can move this DC's PFS bytes over the
        WAN — the data plane's liveness bar for striped transfers."""
        return any(not dtn.down for dtn in self.dtns)

    def offline_index(self, paths: List[str], attr_filter: Optional[List[str]] = None) -> int:
        """LW-Offline extraction: run SDS directly on this DC's DTNs (§III-B5).

        No FUSE, no RPC: each path is indexed in-process on the DTN that owns
        it (hash over this DC's DTNs).  Search still finds the rows because
        queries fan out to every shard.
        """
        if not self.dtns:
            raise RuntimeError(f"DC {self.dc_id} has no DTNs")
        by_dtn: Dict[int, List[str]] = {}
        for path in paths:
            by_dtn.setdefault(hash_placement(path, len(self.dtns)), []).append(path)
        done = 0
        for dtn_idx, group in by_dtn.items():
            done += len(group)
            self.dtns[dtn_idx].discovery.batch_index(group, attr_filter)
        return done


#: (from_dc, to_dc) -> Channel.  None ⇒ free loopback everywhere.
ChannelPolicy = Callable[[str, str], Channel]


def _free_channels(_from_dc: str, _to_dc: str) -> Channel:
    return Channel(name="free")


class Collaboration:
    """The full collaboration fabric: all DCs, all DTNs, shared namespaces.

    ``channel_policy`` supplies the link model used between a collaborator's
    home DC and each DTN's DC — benchmarks use it to model intra-DC vs
    cross-DC (ESnet-class) links; tests leave it free.
    """

    def __init__(self, channel_policy: Optional[ChannelPolicy] = None):
        self.datacenters: Dict[str, DataCenter] = {}
        self.dtns: List[DTN] = []  # global DTN list; index = placement target
        self.namespaces = NamespaceRegistry()
        self.channel_policy: ChannelPolicy = channel_policy or _free_channels
        #: collaboration-wide attribute-cache invalidation fabric (plane layer)
        self.invalidations = InvalidationBus()
        #: active fault plan (``install_faults``); every plane's clients and
        #: journals consult it through a provider, so None = zero overhead
        self.fault_plan = None
        #: why the last quiesce_replication returned False (diagnostics)
        self.quiesce_reason: Optional[str] = None
        #: the last heal-time reconcile's report (see :meth:`reconcile`)
        self.last_reconcile: Optional[Dict[str, object]] = None
        #: telemetry knob defaults planes/DTNs inherit when built without
        #: explicit values (set via :meth:`add_datacenter`'s kwargs)
        self.trace_enabled: Optional[bool] = None
        self.trace_buffer_spans: Optional[int] = None
        self.hist_buckets: Optional[int] = None
        #: fabric-wide telemetry: cluster-scope spans (reconcile) land here
        self.telemetry = Telemetry("cluster")
        #: every span buffer in the fabric (DTNs, planes, the cluster bundle)
        #: — the search set for :meth:`collect_trace`
        self._span_buffers = [self.telemetry.spans]
        #: prefix -> (trace_id, span_id) of the latest degraded quorum write,
        #: so the heal-time reconcile span can join that write's trace
        self._trace_links: Dict[str, tuple] = {}
        self._lock = threading.Lock()

    # -- telemetry ---------------------------------------------------------------
    def register_telemetry(self, telemetry: Telemetry) -> None:
        """Make a bundle's spans findable by :meth:`collect_trace` (DTNs
        self-register; planes register on construction)."""
        with self._lock:
            if telemetry.spans not in self._span_buffers:
                self._span_buffers.append(telemetry.spans)

    def link_trace(self, prefix: str, ctx: Optional[tuple]) -> None:
        """Remember the trace context of a degraded write under ``prefix``;
        the next :meth:`reconcile` covering it parents its span there."""
        if ctx is not None:
            with self._lock:
                self._trace_links[prefix] = ctx

    def observe(self) -> Dict[str, object]:
        """One flat scrape of the server side of the fabric: every DTN's
        registry (RPC servers, lease tables, shard row counts, pump
        counters) folded with the fault plane's and invalidation bus's
        counters.  Client-plane counters live in ``Workspace.telemetry()``,
        which folds this in."""
        snaps = [dtn.telemetry.snapshot() for dtn in self.dtns]
        extra: Dict[str, object] = {"invalidations.published": self.invalidations.published}
        if self.fault_plan is not None:
            for k, v in self.fault_plan.stats().items():
                extra[f"faults.{k}"] = v
        snaps.append(extra)
        return fold_snapshots(snaps)

    def collect_trace(self, trace_id: int) -> Optional[Dict[str, object]]:
        """Assemble the cross-DC span tree for one trace: gather matching
        spans from every registered buffer (client planes, every DTN, the
        cluster bundle) and stitch them by parent links."""
        with self._lock:
            buffers = list(self._span_buffers)
        spans = []
        for buf in buffers:
            spans.extend(buf.for_trace(trace_id))
        return assemble_trace(spans)

    # -- construction -----------------------------------------------------------
    def add_datacenter(
        self,
        dc_id: str,
        *,
        root: Optional[str] = None,
        n_dtns: int = 2,
        db_dir: Optional[str] = None,
        store_gbps: float = 0.0,
        store_lat_s: float = 0.0,
        summary_bits: Optional[int] = None,
        trace_enabled: Optional[bool] = None,
        trace_buffer_spans: Optional[int] = None,
        hist_buckets: Optional[int] = None,
    ) -> DataCenter:
        """Add a DC.  ``root=None`` ⇒ in-memory PFS; else a PosixBackend at root.

        The telemetry knobs (``trace_enabled``, ``trace_buffer_spans``,
        ``hist_buckets`` — see configs/scispace_testbed.py) flow into this
        DC's DTN servers and become the collaboration-wide defaults planes
        built afterwards inherit; ``None`` keeps the module defaults.
        """
        with self._lock:
            if dc_id in self.datacenters:
                raise ValueError(f"duplicate DC id {dc_id!r}")
            if trace_enabled is not None:
                self.trace_enabled = trace_enabled
                self.telemetry.tracer.enabled = trace_enabled
            if trace_buffer_spans is not None:
                self.trace_buffer_spans = trace_buffer_spans
            if hist_buckets is not None:
                self.hist_buckets = hist_buckets
            backend: StorageBackend
            backend = (
                MemoryBackend(dc_id, store_gbps=store_gbps, store_lat_s=store_lat_s)
                if root is None
                else PosixBackend(dc_id, root)
            )
            dc = DataCenter(dc_id, backend)
            for _ in range(n_dtns):
                dtn = DTN(
                    len(self.dtns), dc_id, backend, db_dir, summary_bits=summary_bits,
                    trace_enabled=self.trace_enabled,
                    trace_buffer_spans=self.trace_buffer_spans,
                    hist_buckets=self.hist_buckets,
                )
                dc.dtns.append(dtn)
                self.dtns.append(dtn)
                self._span_buffers.append(dtn.telemetry.spans)
            self.datacenters[dc_id] = dc
            return dc

    def dc(self, dc_id: str) -> DataCenter:
        return self.datacenters[dc_id]

    def owner_dtn(self, path: str) -> DTN:
        """The DTN whose shards own this pathname (hash placement, §III-B1)."""
        return self.dtns[hash_placement(path, len(self.dtns))]

    def replica_set(self, path: str, n: int = REPLICA_N) -> List[int]:
        """The DTN indices responsible for ``path``'s replicated writes: the
        hash-placement owner plus its ring successors, ``min(n, total)``
        members.  Leases are granted by a majority of this set; quorum
        writes ack after W of its members hold the record durably."""
        total = len(self.dtns)
        if total == 0:
            return []
        owner = hash_placement(path, total)
        return [(owner + k) % total for k in range(max(1, min(n, total)))]

    # -- namespace control (replicated to every metadata shard) ------------------
    def define_namespace(self, name: str, scope: str, owner: str, prefix: str):
        ns = self.namespaces.define(name, scope, owner, prefix)
        for dtn in self.dtns:
            dtn.metadata.put_namespace(ns.ns_id, ns.name, ns.scope, ns.owner, ns.prefix)
        return ns

    # -- replication tier --------------------------------------------------------
    @property
    def replication_enabled(self) -> bool:
        return any(dtn.replica_pump is not None for dtn in self.dtns)

    def start_replication(self, **pump_kwargs) -> None:
        """Start one :class:`ReplicaPump` per DTN (async full-mesh shipping).

        Until this is called the logs still accumulate (cheap, in-memory)
        but nothing is shipped — the pre-replication behavior.  Accepts the
        pump's threshold knobs (``max_pending``, ``max_age_s``, ``poll_s``)
        and the wire-path knobs (``batch_limit``, ``compact``, ``deltas``,
        ``adaptive_batch``) — see :class:`~repro_torch.core.replication.ReplicaPump`.
        """
        for dtn in self.dtns:
            if dtn.replica_pump is None:
                dtn.replica_pump = ReplicaPump(dtn, self, **pump_kwargs)
            if not dtn.down:
                dtn.replica_pump.start()

    def quiesce_replication(self, timeout_s: float = 10.0) -> bool:
        """Drain every pump until all reachable replicas converge.

        Draining one DTN's log never appends to another's (applies are not
        re-logged), but a single sweep can race a concurrent writer, so loop
        until a full pass ships nothing.  A mid-loop ``crash_dtn`` (or a
        flapping peer re-entering the reachable set with an old cursor) can
        make the lag sum *oscillate* instead of shrinking — two consecutive
        sweeps without net progress return ``False`` promptly with the
        reason recorded in :attr:`quiesce_reason`, rather than spinning to
        the deadline.
        """
        deadline = time.time() + timeout_s
        self.quiesce_reason = None
        last_lag: Optional[int] = None
        stalled = 0
        while True:
            for dtn in self.dtns:
                if dtn.replica_pump is not None and not dtn.down:
                    dtn.replica_pump.quiesce(timeout_s=max(0.1, deadline - time.time()))
            lag = sum(
                dtn.replica_pump.lag()
                for dtn in self.dtns
                if dtn.replica_pump is not None and not dtn.down
            )
            if lag == 0:
                return True
            stalled = stalled + 1 if (last_lag is not None and lag >= last_lag) else 0
            last_lag = lag
            if stalled >= 2:
                down = [d.dtn_id for d in self.dtns if d.down]
                self.quiesce_reason = (
                    f"no drain progress over {stalled} sweeps: {lag} records still "
                    f"lagging (down DTNs: {down or 'none'}; peer crashed mid-drain "
                    "or a writer is outpacing the pumps)"
                )
                return False
            if time.time() > deadline:
                self.quiesce_reason = f"deadline exceeded with {lag} records lagging"
                return False

    def stop_replication(self) -> None:
        for dtn in self.dtns:
            if dtn.replica_pump is not None:
                dtn.replica_pump.stop()

    def crash_dtn(self, dtn_id: int) -> None:
        self.dtns[dtn_id].crash()

    def restart_dtn(self, dtn_id: int) -> None:
        self.dtns[dtn_id].restart()

    # -- fault plane -------------------------------------------------------------
    def install_faults(self, plan) -> None:
        """Install (or, with ``None``, remove) a
        :class:`~repro_torch.core.faults.FaultPlan`.  Clients consult the plan
        through a provider callable, so installation takes effect on the next
        message — including planes and pumps built before this call.

        ``install_faults(None)`` is a full *heal*: the outgoing plan's
        pending timed restarts are cancelled (and plan-crashed DTNs brought
        back up), its partitions lifted, and its rule cadence/schedule state
        reset, so the collaboration behaves exactly like one that never had
        the plan installed.  The plan's lifetime observability counters
        (``stats()``) survive — they describe what *did* fire.
        """
        if plan is None and self.fault_plan is not None:
            self.fault_plan.deactivate()
        if plan is not None:
            plan.bind(self)
        self.fault_plan = plan

    # -- heal-time anti-entropy --------------------------------------------------
    def reconcile(
        self, prefix: str = "/", timeout_s: float = RECONCILE_TIMEOUT_S
    ) -> Dict[str, object]:
        """Run heal-time anti-entropy over ``prefix`` and return the report
        (see :class:`~repro_torch.core.replication.AntiEntropyReconciler`).  Call
        after ``install_faults(None)`` heals a partition during which
        degraded quorum writes were accepted.

        When a degraded quorum write under ``prefix`` registered a trace
        link (:meth:`link_trace`), the reconcile span joins that write's
        trace as a child — the assembled tree then shows the full causal
        story: lease fan-out, journal intent, quorum pushes, and the
        heal-time convergence that completed them."""
        parent = None
        with self._lock:
            for linked_prefix in sorted(self._trace_links, key=len, reverse=True):
                if linked_prefix.startswith(prefix) or prefix.startswith(linked_prefix):
                    parent = self._trace_links.pop(linked_prefix)
                    break
        reconciler = AntiEntropyReconciler(self, prefix=prefix)
        with self.telemetry.tracer.span("reconcile", parent=parent, prefix=prefix) as sp:
            report = reconciler.run(timeout_s=timeout_s)
            if sp is not None:
                sp.tags.update(
                    records_replayed=report.get("records_replayed", 0),
                    conflicts_resolved=report.get("conflicts_resolved", 0),
                    converged=bool(report.get("converged")),
                )
                if not report.get("converged"):
                    sp.status = "degraded"
        self.last_reconcile = report
        return report

    # -- lifecycle ---------------------------------------------------------------
    def start_async_indexers(self, **kwargs) -> None:
        for dtn in self.dtns:
            dtn.start_async_indexer(**kwargs)

    def close(self) -> None:
        self.stop_replication()
        for dtn in self.dtns:
            dtn.close()
