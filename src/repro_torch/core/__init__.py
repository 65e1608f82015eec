"""SCISPACE core: the paper's contribution as a composable library.

Layers (bottom-up):

- :mod:`repro_torch.core.backends`   — per-data-center PFS stand-ins (+ xattrs)
- :mod:`repro_torch.core.rpc`        — message codec + client/server + channels,
  batched (``call_batch``) and pipelined (``RpcPipeline``) calls
- :mod:`repro_torch.core.scidata`    — self-describing scientific container (HDF5 stand-in)
- :mod:`repro_torch.core.metadata`   — SQLite DB shards + hash placement (Fig. 4)
- :mod:`repro_torch.core.namespace`  — template namespaces, local/global scopes
- :mod:`repro_torch.core.query`      — query language + scatter-gather planner
  (predicate pushdown per shard, central union/intersect merge)
- :mod:`repro_torch.core.discovery`  — Scientific Discovery Service + 3 extraction modes
- :mod:`repro_torch.core.cluster`    — DTNs / data centers / collaboration fabric
- :mod:`repro_torch.core.plane`      — the **unified metadata plane**: pooled
  per-DTN clients, batched/pipelined RPC, bounded scatter-gather fan-out,
  and a write-back attribute cache with path-hash invalidation.  Every
  client (workspace, MEU, benchmarks) talks to services through it.
- :mod:`repro_torch.core.datapath`   — the **data plane**: striped multi-lane
  cross-DC transfers (pipelined store/wire overlap), a consistent
  client-side chunk cache riding the invalidation bus, and asynchronous
  scidata read-ahead.
- :mod:`repro_torch.core.workspace`  — the scifs client (unified namespace) + native access
- :mod:`repro_torch.core.meu`        — Metadata Export Utility (local-write export protocol)
- :mod:`repro_torch.core.replication` — the **replicated metadata tier**: per-DTN
  epoch clocks + append-only replication logs, async ReplicaPumps shipping
  mutations to peer DTNs (bounded lag, (epoch, origin) last-writer-wins),
  and the crash-recoverable write-back journal.
- :mod:`repro_torch.core.faults`     — the **fault plane**: a deterministic,
  seedable :class:`FaultPlan` injecting drops/delays/duplicates, DTN
  crashes, torn journal writes and link partitions at the RPC boundary;
  paired with :class:`~repro_torch.core.rpc.RetryPolicy` (backoff + idempotency
  tokens), per-DTN circuit breakers, and degraded-mode replica failover.
- :mod:`repro_torch.core.leases`     — **partition-tolerant writes**: per-prefix
  epoch-fenced write leases (:class:`LeaseTable` grants, client-side
  :class:`LeaseManager` majority acquisition with sloppy-quorum fallback);
  mutations issued under a lease carry its fencing token, so a superseded
  holder is refused (:class:`~repro_torch.core.rpc.RpcFenced`) before its write
  can reach any replica log.  The plane's quorum-acknowledged degraded
  write path and the heal-time :class:`AntiEntropyReconciler`
  (``Collaboration.reconcile()``) complete the accept-now/reconcile-later
  story.
- :mod:`repro_torch.core.telemetry` — the **telemetry plane**: a unified
  :class:`MetricsRegistry` of typed counters/gauges/histograms with
  hierarchical dotted names (folded cluster-wide by
  ``Collaboration.observe()`` / ``Workspace.telemetry()``), cross-DC
  distributed tracing (trace/span IDs minted at Workspace entry points and
  carried in RPC envelopes; ``Collaboration.collect_trace()`` reassembles
  the causal tree), and per-op timeline profiling
  (:func:`render_timeline`, :func:`chrome_trace`).
"""

from .backends import MemoryBackend, OWNER_XATTR, PosixBackend, StorageBackend, SYNC_XATTR
from .cluster import Collaboration, DataCenter, DTN
from .datapath import ChunkCache, DataPath, TransferInterrupted
from .discovery import AsyncIndexer, DiscoveryService, ExtractionMode
from .faults import CANNED_PLANS, FaultPlan, TornWrite, canned_plan
from .leases import (
    Lease,
    LeaseError,
    LeaseHeldElsewhere,
    LeaseManager,
    LeaseTable,
    LeaseUnavailable,
)
from .metadata import DiscoveryShard, MetadataService, MetadataShard, hash_placement, path_hash
from .meu import MEU, ExportReport
from .namespace import DEFAULT_NS, Namespace, NamespaceRegistry
from .plane import AttrCache, CircuitBreaker, InvalidationBus, ServicePlane
from .query import Query, QueryError, ScatterGatherPlan, parse_query, plan_query
from .replication import (
    AntiEntropyReconciler,
    EpochClock,
    ReplicaPump,
    ReplicationLog,
    WriteBackJournal,
)
from .rpc import (
    Channel,
    RetryPolicy,
    RpcClient,
    RpcError,
    RpcFenced,
    RpcFuture,
    RpcPipeline,
    RpcServer,
    RpcTimeout,
    RpcUnavailable,
    pack,
    unpack,
)
from .telemetry import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    Span,
    SpanBuffer,
    Telemetry,
    Tracer,
    assemble_trace,
    chrome_trace,
    fold_snapshots,
    render_timeline,
)
from .scidata import (
    SciFile,
    attr_type_of,
    read_dataset,
    read_header,
    serialize_scidata,
    write_scidata,
)
from .workspace import NativeSession, Workspace, WriteResult

__all__ = [
    "MemoryBackend",
    "PosixBackend",
    "StorageBackend",
    "SYNC_XATTR",
    "OWNER_XATTR",
    "Collaboration",
    "DataCenter",
    "DTN",
    "ChunkCache",
    "DataPath",
    "TransferInterrupted",
    "CANNED_PLANS",
    "FaultPlan",
    "TornWrite",
    "canned_plan",
    "AsyncIndexer",
    "DiscoveryService",
    "ExtractionMode",
    "DiscoveryShard",
    "MetadataService",
    "MetadataShard",
    "hash_placement",
    "path_hash",
    "MEU",
    "ExportReport",
    "DEFAULT_NS",
    "Namespace",
    "NamespaceRegistry",
    "AttrCache",
    "CircuitBreaker",
    "InvalidationBus",
    "ServicePlane",
    "AntiEntropyReconciler",
    "EpochClock",
    "ReplicaPump",
    "ReplicationLog",
    "WriteBackJournal",
    "Lease",
    "LeaseError",
    "LeaseHeldElsewhere",
    "LeaseManager",
    "LeaseTable",
    "LeaseUnavailable",
    "Query",
    "QueryError",
    "ScatterGatherPlan",
    "parse_query",
    "plan_query",
    "Channel",
    "RetryPolicy",
    "RpcClient",
    "RpcError",
    "RpcFenced",
    "RpcFuture",
    "RpcPipeline",
    "RpcServer",
    "RpcTimeout",
    "RpcUnavailable",
    "pack",
    "unpack",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "Span",
    "SpanBuffer",
    "Telemetry",
    "Tracer",
    "assemble_trace",
    "chrome_trace",
    "fold_snapshots",
    "render_timeline",
    "SciFile",
    "attr_type_of",
    "read_dataset",
    "read_header",
    "serialize_scidata",
    "write_scidata",
    "NativeSession",
    "Workspace",
    "WriteResult",
]
