"""The Scientific Collaboration Workspace client — ``scifs`` (§III-B1, Fig. 3).

One :class:`Workspace` instance is one collaborator's mount of the unified
namespace.  It provides POSIX-like operations (create/write/read/ls/stat/
mkdir) over every data center in the collaboration:

- **placement**: an incoming write is assigned a DTN by hashing the file
  pathname; the file's data lands in that DTN's data-center PFS and its
  metadata in that DTN's metadata shard;
- **FUSE five-op sequence**: the paper measures that FUSE "invokes five
  operations serially: getattr, lookup, create, write and flush" (§IV-C).
  The workspace issues the same sequence as explicit metadata RPCs.  By
  default (``pipeline=True``) the four metadata ops ride **one pipelined
  batch** to the owner DTN — one channel round-trip, four serializations —
  via the :class:`~repro_torch.core.plane.ServicePlane`; ``pipeline=False`` keeps
  the paper's serial per-op sequence for comparison (benchmarks/fig9d).
  With ``write_back=True`` the final flush op is buffered in the plane's
  write-back attribute cache and committed later as one batched ``update``
  per DTN (:meth:`flush`), trading metadata visibility lag for another
  round-trip off the write path;
- **ls** scatter-gathers to all DTNs with bounded concurrency and shows only
  entries with ``sync=true`` that are visible under the requester's
  namespaces;
- **stat** is served from the plane's attribute cache when possible; writes
  by other collaborators evict entries via path-hash invalidation, so a hit
  is never stale;
- **search** runs the scatter-gather query planner: predicates are pushed
  down to every discovery shard in one batched RPC per shard and the file
  sets are merged centrally (§III-B5);
- **SDS coupling**: scidata writes trigger attribute extraction according to
  the configured :class:`~repro_torch.core.discovery.ExtractionMode`;
- **data plane**: every cross-DC byte rides the mount's
  :class:`~repro_torch.core.datapath.DataPath` — striped over ``data_lanes``
  concurrent lanes in ``stripe_bytes`` chunks (store latency pipelined
  against wire time), served from a ``chunk_cache_bytes`` LRU chunk cache
  kept consistent by the collaboration's path-hash invalidation bus, and
  warmed by scidata ``readahead`` (after a header read the next dataset's
  payload is prefetched in directory order).  Home-DC accesses bypass all of
  it — a local read is a plain PFS access, preserving the paper's
  native-vs-workspace framing.

Native access (SCISPACE-LW) is the *absence* of this client: collaborators
write straight into their local DC's backend via :class:`NativeSession` and
later export metadata with :class:`~repro_torch.core.meu.MEU`.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional

import numpy as np

from .backends import StorageBackend, SYNC_XATTR
from .cluster import Collaboration, DataCenter, DTN
from .datapath import CHUNK_CACHE_BYTES, DATA_LANES, DataPath, STRIPE_BYTES
from .discovery import ExtractionMode
from .plane import ServicePlane
from .query import plan_query
from .rpc import RetryPolicy, RpcUnavailable
from .scidata import (
    SciFile,
    dataset_range,
    read_dataset_via,
    read_header_via,
    serialize_scidata,
    write_scidata as _write_scidata_backend,
)

__all__ = ["Workspace", "NativeSession", "WriteResult"]


class WriteResult(int):
    """A :meth:`Workspace.write` return value that stays an ``int`` (bytes
    written — every existing caller keeps working) while flagging how the
    write was accepted.  ``degraded`` marks a partition-accepted write: the
    owner was unreachable and the mutation was quorum-acknowledged by
    ``quorum`` replica-set members under an epoch-fenced lease instead."""

    degraded: bool
    quorum: int
    entry: Optional[Dict[str, Any]]

    def __new__(
        cls,
        n: int,
        *,
        degraded: bool = False,
        quorum: int = 0,
        entry: Optional[Dict[str, Any]] = None,
    ) -> "WriteResult":
        obj = super().__new__(cls, n)
        obj.degraded = degraded
        obj.quorum = quorum
        obj.entry = entry
        return obj


def _norm(path: str) -> str:
    path = "/" + path.strip("/")
    while "//" in path:
        path = path.replace("//", "/")
    return path


def _traced(name: str):
    """Mint (or continue) a trace around a Workspace entry point.

    Every public operation runs under a span named ``ws.<op>``; with no
    active context on the thread this starts a new trace (whose id the
    plane tracer remembers as ``last_trace``), and RPCs issued inside
    propagate ``[trace_id, span_id]`` on their envelopes so server-side
    spans land in the same tree.  ``trace_enabled=False`` short-circuits
    to a plain call.
    """
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(self, *args, **kwargs):
            tracer = self.plane.telemetry.tracer
            if not tracer.enabled:
                return fn(self, *args, **kwargs)
            if args and isinstance(args[0], str):
                with tracer.span(name, path=args[0]):
                    return fn(self, *args, **kwargs)
            with tracer.span(name):
                return fn(self, *args, **kwargs)
        return wrapper
    return deco


class Workspace:
    """A collaborator's mounted view of the collaboration (``/mnt/scifs``)."""

    def __init__(
        self,
        collab: Collaboration,
        collaborator: str,
        home_dc: str,
        *,
        extraction_mode: str = ExtractionMode.INLINE_ASYNC,
        attr_filter: Optional[List[str]] = None,
        pipeline: bool = True,
        write_back: bool = False,
        max_inflight: int = 8,
        cache_entries: int = 4096,
        journal_path: Optional[str] = None,
        wb_max_pending: Optional[int] = None,
        wb_max_age_s: Optional[float] = None,
        prefer_replica: bool = False,
        prune_queries: bool = True,
        summary_ttl_s: Optional[float] = None,
        stripe_bytes: int = STRIPE_BYTES,
        data_lanes: int = DATA_LANES,
        chunk_cache_bytes: int = CHUNK_CACHE_BYTES,
        readahead: bool = True,
        retry: Optional[RetryPolicy] = None,
        breaker_threshold: Optional[int] = None,
        breaker_cooldown_s: Optional[float] = None,
        failover: bool = True,
        write_quorum: Optional[int] = None,
        lease_ttl_s: Optional[float] = None,
        trace_enabled: Optional[bool] = None,
        trace_buffer_spans: Optional[int] = None,
        hist_buckets: Optional[int] = None,
    ):
        """``stripe_bytes`` / ``data_lanes`` shape the striped multi-lane
        transfer (0 / 1 restore the single-shot path); ``chunk_cache_bytes``
        sizes the consistent remote-read chunk cache (0 disables it);
        ``readahead`` toggles asynchronous scidata payload prefetch.  All
        four ride :class:`~repro.configs.scispace_testbed.TestbedConfig`.

        ``retry`` (a :class:`~repro_torch.core.rpc.RetryPolicy`) makes every RPC
        and striped transfer retry unavailability with backoff + idempotency
        tokens; ``breaker_*`` tune the per-DTN circuit breakers; ``failover``
        lets stat/ls/search degrade to home-DC replicas (stale rows flagged)
        while an origin is unreachable — ``False`` is the fail-fast
        baseline."""
        if extraction_mode not in ExtractionMode.ALL:
            raise ValueError(f"unknown extraction mode {extraction_mode!r}")
        self.collab = collab
        self.collaborator = collaborator
        self.home_dc = home_dc
        self.extraction_mode = extraction_mode
        self.attr_filter = attr_filter
        self.pipeline = pipeline
        self.write_back = write_back
        self.prefer_replica = prefer_replica
        self.prune_queries = prune_queries
        # All service interaction goes through the metadata plane: pooled
        # per-DTN clients, batched RPC, bounded scatter-gather, attr cache,
        # and (write_back) the crash-recoverable journal with count/age
        # flush thresholds.
        plane_kwargs: Dict[str, Any] = dict(
            max_inflight=max_inflight,
            cache_entries=cache_entries,
            write_back=write_back,
            journal_path=journal_path,
            prefer_replica=prefer_replica,
            retry=retry,
            failover=failover,
        )
        if wb_max_pending is not None:
            plane_kwargs["wb_max_pending"] = wb_max_pending
        if wb_max_age_s is not None:
            plane_kwargs["wb_max_age_s"] = wb_max_age_s
        if summary_ttl_s is not None:
            plane_kwargs["summary_ttl_s"] = summary_ttl_s
        if breaker_threshold is not None:
            plane_kwargs["breaker_threshold"] = breaker_threshold
        if breaker_cooldown_s is not None:
            plane_kwargs["breaker_cooldown_s"] = breaker_cooldown_s
        if write_quorum is not None:
            plane_kwargs["write_quorum"] = write_quorum
        if lease_ttl_s is not None:
            plane_kwargs["lease_ttl_s"] = lease_ttl_s
        if trace_enabled is not None:
            plane_kwargs["trace_enabled"] = trace_enabled
        if trace_buffer_spans is not None:
            plane_kwargs["trace_buffer_spans"] = trace_buffer_spans
        if hist_buckets is not None:
            plane_kwargs["hist_buckets"] = hist_buckets
        self.plane = ServicePlane(collab, home_dc, **plane_kwargs)
        # The data plane: every cross-DC byte moves through it (striped
        # lanes + chunk cache + read-ahead); home-DC bytes stay direct.
        # It shares the plane's tracer + registry, so striped lanes and
        # prefetches land in the same traces as the metadata RPCs.
        self.datapath = DataPath(
            collab,
            home_dc,
            stripe_bytes=stripe_bytes,
            data_lanes=data_lanes,
            chunk_cache_bytes=chunk_cache_bytes,
            readahead=readahead,
            retry=retry,
            tracer=self.plane.telemetry.tracer,
            metrics=self.plane.telemetry.registry,
        )
        self.plane.telemetry.add_collector("datapath", self.datapath.stats_flat)
        # our own metadata publications must not evict our own freshly
        # written-through chunks
        self.plane.attach_cache(self.datapath.cache)

    # -- internals ---------------------------------------------------------------
    def _owner(self, path: str) -> int:
        return self.plane.owner(path)

    def _dtn(self, path: str) -> DTN:
        return self.collab.dtns[self._owner(path)]

    def _ns_id(self, path: str) -> int:
        return self.collab.namespaces.resolve(path).ns_id

    @staticmethod
    def _entry_epoch(entry: Optional[Dict[str, Any]]) -> int:
        """The freshness fence a data read carries into the chunk cache: bytes
        cached under an older epoch than the metadata row cannot be served."""
        return int(entry.get("epoch", 0) or 0) if entry else 0

    # -- POSIX-like surface ---------------------------------------------------
    @_traced("ws.write")
    def write(self, path: str, data: bytes) -> int:
        """The five-op FUSE sequence + data-plane write + SDS coupling."""
        path = _norm(path)
        dtn = self._dtn(path)
        owner_idx = self._owner(path)
        parent = path.rsplit("/", 1)[0] or "/"
        create_kw = dict(
            path=path,
            owner=self.collaborator,
            dc_id=dtn.dc_id,
            ns_id=self._ns_id(path),
            is_dir=False,
            sync=True,
        )
        try:
            if self.pipeline:
                calls = [
                    ("getattr", {"path": parent}),          # 1 getattr
                    ("lookup", {"path": path}),             # 2 lookup
                    ("create", create_kw),                  # 3 create
                ]
                if not self.write_back:
                    calls.append(                           # 5 flush (same batch)
                        ("update", {"path": path, "size": len(data), "sync": True})
                    )
                results = self.plane.meta_batch(owner_idx, calls)
                entry = results[2]
            else:
                # the paper's serial sequence: one channel round-trip per op
                self.plane.meta_call(owner_idx, "getattr", path=parent)     # 1
                self.plane.meta_call(owner_idx, "lookup", path=path)        # 2
                entry = self.plane.meta_call(owner_idx, "create", **create_kw)  # 3
                if not self.write_back:
                    self.plane.meta_call(                                    # 5
                        owner_idx, "update", path=path, size=len(data), sync=True
                    )
        except RpcUnavailable as exc:
            # the owner is unreachable (partition, crash, open breaker):
            # degrade to the quorum-acknowledged lease-fenced write path
            # instead of failing — the write is accepted locally and
            # converges on heal (anti-entropy reconciliation)
            return self._degraded_write(path, data, exc)
        if dtn.dc_id == self.home_dc:                   # 4 write (local PFS)
            dtn.backend.write(path, data, owner=self.collaborator)
        else:                                           # 4 write (data plane:
            # striped over the lane pool, written through into the cache)
            self.datapath.write(
                dtn.dc_id,
                path,
                data,
                owner=self.collaborator,
                epoch=self._entry_epoch(entry),
            )
        entry["size"] = len(data)
        self.plane.note_entry(entry)
        if self.write_back:
            # 5 flush — buffered as a dirty cache entry, committed in one
            # batched update per DTN at the next flush()/barrier/close.
            self.plane.defer_update(path, size=len(data), sync=True)
        dtn.backend.set_xattr(path, SYNC_XATTR, "true")
        self._index_hook(path, dtn, len(data))
        return len(data)

    def _degraded_write(
        self, path: str, data: bytes, exc: RpcUnavailable
    ) -> WriteResult:
        """Partition-tolerant write: accept the mutation at home.

        The bytes land in the writer's home-DC backend (XUFS-style
        accept-locally, reconcile-later) and the metadata row — stamped
        ``dc_id = home`` so readers fetch the bytes from where they actually
        are — is created by a reachable coordinator under an epoch-fenced
        lease and acknowledged only after a quorum of replica-set members
        durably applied it (:meth:`ServicePlane.quorum_create`).  The healed
        owner converges through the replication pump + anti-entropy
        reconciliation.  With ``failover=False`` (the fail-fast baseline) or
        no replication tier the original unavailability propagates.
        """
        plane = self.plane
        if not (plane.failover and self.collab.replication_enabled and plane.local_dtns):
            raise exc
        create_kw = dict(
            path=path,
            owner=self.collaborator,
            dc_id=self.home_dc,
            ns_id=self._ns_id(path),
            is_dir=False,
            sync=True,
            size=len(data),
        )
        res = plane.quorum_create(path, create_kw)
        # the write succeeded, but through the quorum path — mark the
        # enclosing ws.write span so the trace tells the whole story
        plane.telemetry.tracer.annotate(status="degraded")
        entry = dict(res["entry"])
        backend = self.collab.dc(self.home_dc).backend
        backend.write(path, data, owner=self.collaborator)
        backend.set_xattr(path, SYNC_XATTR, "true")
        plane.note_entry(entry)
        self._degraded_index_hook(path, len(data))
        return WriteResult(
            len(data), degraded=True, quorum=int(res["acks"]), entry=entry
        )

    def _degraded_index_hook(self, path: str, size: int) -> None:
        """SDS coupling for a degraded write: register at a reachable home-DC
        shard (origin role — the index rows converge via the pump) instead of
        the unreachable owner.  Best-effort: with no reachable shard the
        heal-time reconciler still converges the index."""
        if self.extraction_mode not in (
            ExtractionMode.INLINE_SYNC,
            ExtractionMode.INLINE_ASYNC,
        ):
            return
        for idx in self.plane.local_dtns:
            try:
                if self.extraction_mode == ExtractionMode.INLINE_SYNC:
                    self.plane.sds_call(
                        idx,
                        "extract_and_index",
                        path=path,
                        attr_filter=self.attr_filter,
                        stat_size=size,
                    )
                else:
                    self.plane.sds_call(
                        idx, "enqueue_index", path=path, dc_id=self.home_dc
                    )
                return
            except RpcUnavailable:
                continue

    def _index_hook(self, path: str, dtn: DTN, size: int) -> None:
        if self.extraction_mode == ExtractionMode.INLINE_SYNC:
            # write completes only after extraction+indexing (§III-B5)
            self.plane.sds_call(
                dtn.dtn_id,
                "extract_and_index",
                path=path,
                attr_filter=self.attr_filter,
                stat_size=size,
            )
        elif self.extraction_mode == ExtractionMode.INLINE_ASYNC:
            # a single registration message; indexing happens later
            self.plane.sds_call(dtn.dtn_id, "enqueue_index", path=path, dc_id=dtn.dc_id)
        # NONE / LW_OFFLINE: nothing in the write path

    @_traced("ws.flush")
    def flush(self) -> int:
        """Commit write-back metadata updates (one batched RPC per DTN)."""
        return self.plane.flush()

    @_traced("ws.read")
    def read(self, path: str) -> bytes:
        """Whole-file read: home-DC files straight off the PFS, remote files
        through the data plane (striped lanes, chunk-cache hits at
        home-DC cost, byte-identical either way)."""
        path = _norm(path)
        entry = self.plane.stat(path)
        if entry is None:
            raise FileNotFoundError(path)
        dc_id = entry["dc_id"]
        if dc_id == self.home_dc:
            return self.collab.dc(dc_id).backend.read(path)
        return self.datapath.read(dc_id, path, epoch=self._entry_epoch(entry))

    @_traced("ws.stat")
    def stat(self, path: str) -> Optional[Dict[str, Any]]:
        """Attribute lookup; a plane-cache hit costs zero RPCs."""
        return self.plane.stat(_norm(path))

    @_traced("ws.exists")
    def exists(self, path: str) -> bool:
        path = _norm(path)
        if not self.plane.cache.is_miss(self.plane.cache.get(path)):
            return True
        return bool(self.plane.meta_call(self._owner(path), "lookup", path=path))

    @_traced("ws.mkdir")
    def mkdir(self, path: str) -> None:
        path = _norm(path)
        dtn = self._dtn(path)
        entry = self.plane.meta_call(
            self._owner(path),
            "create",
            path=path,
            owner=self.collaborator,
            dc_id=dtn.dc_id,
            ns_id=self._ns_id(path),
            is_dir=True,
            sync=True,
        )
        dtn.backend.mkdir(path, owner=self.collaborator)
        self.plane.note_entry(entry)

    def _merge_listing(self, per_dtn: List[Any]) -> List[Dict[str, Any]]:
        """Merge per-DTN listing replies; under replication the same path may
        come back from several DTNs, so keep the (epoch, origin)-newest row
        and tag rows served by a DTN other than the path's owner."""
        best: Dict[str, Dict[str, Any]] = {}
        for idx, entries in enumerate(per_dtn):
            for e in entries or []:
                stamp = (e.get("epoch", 0), e.get("origin", -1))
                cur = best.get(e["path"])
                if cur is None or stamp > (cur.get("epoch", 0), cur.get("origin", -1)):
                    if idx != self.plane.owner(e["path"]):
                        e = dict(e)
                        e["replica"] = {"dtn": idx, "origin": self.plane.owner(e["path"])}
                    best[e["path"]] = e
        return [best[p] for p in sorted(best)]

    def _replica_listing(self, method: str, kw: Dict[str, Any]) -> Optional[List[Any]]:
        """Home-DC-only listing, or None when a replica cannot prove it has
        applied every epoch this mount has witnessed (session consistency —
        the caller then falls back to the full fan-out).  Each reply carries
        the shard's applied watermarks for the freshness judgement."""
        if not (self.prefer_replica and self.collab.replication_enabled and self.plane.local_dtns):
            return None
        try:
            per_dtn = self.plane.scatter(
                "meta", f"{method}_replica",
                per_dtn_kwargs={i: dict(kw) for i in self.plane.local_dtns},
            )
        except RpcUnavailable:
            return None  # a home replica is down: the fan-out path decides
        bars = self.plane.seen_epochs()
        merged: List[Any] = [None] * len(per_dtn)
        for i in self.plane.local_dtns:
            reply = per_dtn[i] or {}
            applied = {int(k): v for k, v in (reply.get("applied") or {}).items()}
            if not all(
                applied.get(o, 0) >= bar
                for o, bar in bars.items()
                if bar > 0 and o != i
            ):
                self.plane.replica_stale_fallbacks += 1
                return None
            merged[i] = reply.get("entries")
        return merged

    def _flush_for_listing(self) -> None:
        """Write-back entries must be visible to listings — but during an
        outage the flush owner may be unreachable; the journal keeps the
        updates and retries later, and the listing proceeds degraded."""
        try:
            self.plane.flush()
        except RpcUnavailable:
            pass

    def _degraded_listing(
        self, method: str, kw: Dict[str, Any], exc: RpcUnavailable
    ) -> List[Dict[str, Any]]:
        """Listing failover: some DTN in the fan-out is unreachable, so serve
        the whole listing from home-DC replicas.  Replicas that lag this
        mount's session bar still serve — availability over freshness — but
        every returned row is then flagged ``stale``.  With no reachable
        replica (or ``failover=False``) the original failure propagates."""
        plane = self.plane
        if not (plane.failover and self.collab.replication_enabled and plane.local_dtns):
            raise exc
        bars = plane.seen_epochs()
        per_dtn: List[Any] = [None] * plane.n_dtns()
        reached = False
        stale = False
        for i in plane.local_dtns:
            try:
                reply = plane.guarded_call("meta", i, f"{method}_replica", **kw)
            except RpcUnavailable:
                continue
            reached = True
            applied = {int(k): v for k, v in (reply.get("applied") or {}).items()}
            if not all(
                applied.get(o, 0) >= bar for o, bar in bars.items() if bar > 0 and o != i
            ):
                stale = True
            per_dtn[i] = reply.get("entries")
        if not reached:
            raise exc
        plane.degraded_reads += 1
        merged = self._merge_listing(per_dtn)
        if stale:
            plane.stale_serves += 1
            merged = [dict(e, stale=True) for e in merged]
        return merged

    @_traced("ws.ls")
    def ls(self, path: str = "/") -> List[Dict[str, Any]]:
        """Scatter-gather listings (§III-B1), bounded fan-out; with
        ``prefer_replica`` only the home-DC replicas are contacted (full
        fan-out fallback when they are stale).  An unreachable DTN degrades
        the listing to home-DC replicas (rows flagged ``stale`` when the
        session bar is unmet) instead of failing."""
        path = _norm(path)
        self._flush_for_listing()
        kw = {"parent": path, "requester": self.collaborator}
        per_dtn = self._replica_listing("list_dir", kw)
        if per_dtn is None:
            try:
                per_dtn = self.plane.scatter("meta", "list_dir", kw)
            except RpcUnavailable as exc:
                return self._degraded_listing("list_dir", kw, exc)
        return self._merge_listing(per_dtn)

    @_traced("ws.find")
    def find(self, prefix: str = "/") -> List[Dict[str, Any]]:
        """Recursive listing (global view of all shared datasets)."""
        prefix = _norm(prefix)
        self._flush_for_listing()
        kw = {"requester": self.collaborator, "prefix": prefix}
        per_dtn = self._replica_listing("list_all", kw)
        if per_dtn is None:
            try:
                per_dtn = self.plane.scatter("meta", "list_all", kw)
            except RpcUnavailable as exc:
                return self._degraded_listing("list_all", kw, exc)
        return self._merge_listing(per_dtn)

    @_traced("ws.delete")
    def delete(self, path: str) -> None:
        """Owner-only removal (the paper defers remote removal; §III-B1)."""
        path = _norm(path)
        entry = self.stat(path)
        if entry is None:
            raise FileNotFoundError(path)
        if entry["owner"] != self.collaborator:
            raise PermissionError(f"{self.collaborator} does not own {path}")
        self.plane.meta_call(self._owner(path), "delete", path=path)
        self.plane.note_remove(path)
        # our own chunk cache is excluded from our publications — drop the
        # dead bytes explicitly (other mounts learn via the bus)
        self.datapath.invalidate(path)
        dc = self.collab.dc(entry["dc_id"])
        if dc.backend.exists(path):
            dc.backend.delete(path)

    # -- scientific data + discovery ----------------------------------------------
    @_traced("ws.write_scidata")
    def write_scidata(self, path: str, arrays: Dict[str, np.ndarray], attrs: Dict[str, Any]) -> int:
        """Write a self-describing dataset through the workspace."""
        return self.write(path, serialize_scidata(arrays, attrs))

    def _range_reader(self, entry: Dict[str, Any], path: str):
        """A ``(offset, length) -> bytes`` reader for scidata parsing: the
        local PFS for home-DC files, the data plane for remote ones — so
        remote header bytes are charged on the data channel (and the chunk
        cache makes repeated header reads legitimately free)."""
        dc_id = entry["dc_id"]
        if dc_id == self.home_dc:
            backend = self.collab.dc(dc_id).backend
            return lambda off, ln: backend.read(path, offset=off, length=ln)
        epoch = self._entry_epoch(entry)
        return lambda off, ln: self.datapath.read_range(dc_id, path, off, ln, epoch=epoch)

    def _readahead(self, entry: Dict[str, Any], path: str, sci: SciFile, after: Optional[str]) -> None:
        """Directory-ordered scidata read-ahead: after a header read prefetch
        the first dataset's payload; after reading dataset *i* prefetch
        dataset *i+1* — the access pattern of a collaborator walking a
        container.  Best-effort and remote-only (local reads are cheap)."""
        if entry["dc_id"] == self.home_dc or not sci.datasets:
            return
        if after is None:
            targets = sci.datasets[:1]
        else:
            idx = next(
                (i for i, d in enumerate(sci.datasets) if d["name"] == after), None
            )
            if idx is None or idx + 1 >= len(sci.datasets):
                return
            targets = [sci.datasets[idx + 1]]
        ranges = []
        for d in targets:
            off, nbytes = dataset_range(sci, d)
            if nbytes > 0:
                ranges.append((off, off + nbytes))
        if ranges:
            self.datapath.prefetch(
                entry["dc_id"], path, ranges, epoch=self._entry_epoch(entry)
            )

    @_traced("ws.read_attrs")
    def read_attrs(self, path: str) -> Dict[str, Any]:
        path = _norm(path)
        entry = self.stat(path)
        if entry is None:
            raise FileNotFoundError(path)
        sci = read_header_via(self._range_reader(entry, path), path)
        self._readahead(entry, path, sci, after=None)
        return sci.attrs

    @_traced("ws.read_dataset")
    def read_dataset(self, path: str, name: str) -> np.ndarray:
        path = _norm(path)
        entry = self.stat(path)
        if entry is None:
            raise FileNotFoundError(path)
        reader = self._range_reader(entry, path)
        sci = read_header_via(reader, path)
        arr = read_dataset_via(reader, name, path, sci=sci)
        self._readahead(entry, path, sci, after=name)
        return arr

    @_traced("ws.tag")
    def tag(self, path: str, name: str, value: Any) -> None:
        """Manual attribute tagging (§III-B5).  When the owning shard is
        unreachable the tag is accepted at a reachable home-DC shard in
        origin role (it converges via the pump + heal-time reconciliation)
        rather than failing — the write-availability analogue of the
        degraded read paths."""
        path = _norm(path)
        dtn = self._dtn(path)
        try:
            self.plane.sds_call(dtn.dtn_id, "tag", path=path, name=name, value=value)
            return
        except RpcUnavailable as exc:
            plane = self.plane
            if not (plane.failover and self.collab.replication_enabled):
                raise
            for idx in plane.local_dtns:
                if idx == dtn.dtn_id:
                    continue
                try:
                    plane.guarded_call(
                        "sds", idx, "tag", path=path, name=name, value=value
                    )
                    plane.degraded_writes += 1
                    return
                except RpcUnavailable:
                    continue
            raise exc

    @_traced("ws.search")
    def search(self, query: str) -> List[Dict[str, Any]]:
        """Attribute query via the scatter-gather planner (§III-B5).

        Each shard receives ONE RPC carrying every predicate and replies with
        its per-predicate path sets plus the rows of its local matches; the
        plane fans the shards out concurrently and the file sets are merged
        centrally (union over shards, intersection over predicates, in
        fixed-size tree-merge groups) — correct even when one file's rows
        span shards, in one round-trip per shard.

        With ``prefer_replica`` and the replication tier running, the whole
        query is first tried against ONE home-DC replica shard — it holds a
        replica of every origin's rows, so a single intra-DC round-trip
        answers the query.  The reply carries the shard's applied-epoch map;
        if any origin this client has witnessed is not yet applied there,
        the result may miss those writes and the query falls back to the
        full fan-out.

        The fan-out itself is **shard-pruned**: each discovery reply
        piggybacks the shard's bloom summary (and the replication log ships
        every shard's summary to every replica), so the plane accumulates a
        filter per shard.  Before fanning out, the plan drops every
        (shard, predicate) pair the summaries prove cannot match — bloom
        bits are one-sided, so a skip is never wrong — and a predicate with
        zero candidate shards short-circuits the whole query to ``[]`` with
        zero RPCs.  Missing or stale summaries degrade to the plain full
        pushdown, never to a wrong answer.
        """
        plan = plan_query(query)
        all_preds = plan.predicate_messages()
        msg = {"predicates": all_preds}
        if self.prefer_replica and self.collab.replication_enabled and self.plane.local_dtns:
            nearest = self.plane.local_dtns[0]
            try:
                reply = self.plane.guarded_call("sds", nearest, "scatter_query", **msg)
            except RpcUnavailable:
                reply = None  # nearest replica down: the fan-out path decides
            if reply is not None:
                applied = {int(k): v for k, v in (reply.get("applied") or {}).items()}
                fresh = all(
                    applied.get(i, 0) >= bar
                    for i, bar in self.plane.seen_epochs().items()
                    if bar > 0 and i != nearest
                )
                self.plane.note_summary(nearest, reply)
                if fresh:
                    paths = set(plan.merge([reply["matches"]]))
                    return [
                        {"path": row["path"], "attrs": row["attrs"], "replica": {"dtn": nearest}}
                        for row in reply["rows"]
                        if row["path"] in paths
                    ]
                self.plane.replica_stale_fallbacks += 1
        n_shards = self.plane.n_dtns()
        summaries = (
            self.plane.fresh_summaries() if self.prune_queries else {}
        )  # TTL-cache reuse (opt-in)
        if (
            self.prune_queries
            and len(summaries) < n_shards
            and self.collab.replication_enabled
            and self.plane.local_dtns
        ):
            # one intra-DC RPC fetches every shard's filter from a home-DC
            # replica (the replication log ships + maintains them there);
            # each filter is session-gated on the replica's applied map
            try:
                warmed = self.plane.note_summaries_bulk(
                    self.plane.guarded_call("sds", self.plane.local_dtns[0], "summaries")
                )
                warmed.update(summaries)
                summaries = warmed
            except RpcUnavailable:
                pass  # no pruning help available; full pushdown still works
        decision = plan.prune(summaries, n_shards)
        self.plane.shard_contacts += decision.contacted()
        self.plane.shards_pruned += decision.pruned_shards
        if decision.empty:
            # some predicate has zero candidate shards ⇒ the conjunction is
            # provably empty; answered without contacting any shard
            self.plane.pruned_empty_queries += 1
            return []
        try:
            per_dtn = self.plane.scatter(
                "sds",
                "scatter_query",
                per_dtn_kwargs={
                    i: {"predicates": [all_preds[j] for j in idxs]}
                    for i, idxs in decision.send.items()
                },
            )
        except RpcUnavailable as exc:
            return self._degraded_search(plan, all_preds, exc)
        # re-inflate each reply's match lists to global predicate positions:
        # a pruned (shard, predicate) pair contributes the empty set its
        # summary proved, so the union-then-intersect merge is unchanged
        matrices: List[List[List[str]]] = []
        for i, reply in enumerate(per_dtn):
            if reply is None:
                continue
            self.plane.note_summary(i, reply)
            full = [[] for _ in all_preds]
            for k, j in enumerate(decision.send[i]):
                full[j] = reply["matches"][k]
            matrices.append(full)
        paths = set(plan.merge(matrices))
        if not paths:
            return []
        merged: Dict[str, Dict[str, Any]] = {}
        for reply in per_dtn:
            if reply is None:
                continue
            for row in reply["rows"]:
                if row["path"] in paths:
                    merged.setdefault(row["path"], {}).update(row["attrs"])
        return [{"path": p, "attrs": merged[p]} for p in sorted(merged)]

    def _degraded_search(self, plan, all_preds, exc: RpcUnavailable) -> List[Dict[str, Any]]:
        """Search failover: answer the whole query from ONE home-DC replica
        shard (it holds a replica of every origin's rows) while part of the
        fan-out is unreachable.  Rows are flagged ``degraded`` — and
        ``stale`` when the replica lags this mount's session bar."""
        plane = self.plane
        if not (plane.failover and self.collab.replication_enabled and plane.local_dtns):
            raise exc
        bars = plane.seen_epochs()
        for i in plane.local_dtns:
            try:
                reply = plane.guarded_call("sds", i, "scatter_query", predicates=all_preds)
            except RpcUnavailable:
                continue
            applied = {int(k): v for k, v in (reply.get("applied") or {}).items()}
            stale = not all(
                applied.get(o, 0) >= bar for o, bar in bars.items() if bar > 0 and o != i
            )
            plane.degraded_reads += 1
            if stale:
                plane.stale_serves += 1
            paths = set(plan.merge([reply["matches"]]))
            out = []
            for row in reply["rows"]:
                if row["path"] in paths:
                    e = {
                        "path": row["path"],
                        "attrs": row["attrs"],
                        "replica": {"dtn": i},
                        "degraded": True,
                    }
                    if stale:
                        e["stale"] = True
                    out.append(e)
            return out
        raise exc

    def search_paths(self, query: str) -> List[str]:
        return [e["path"] for e in self.search(query)]

    # -- accounting -----------------------------------------------------------------
    def telemetry(self) -> Dict[str, Any]:
        """Single unified scrape of every counter this workspace can see.

        Folds the client plane's own registry (``rpc.*``, ``plane.*``,
        ``attrcache.*``, ``lease.*``, ``datapath.*``) with the cluster-wide
        fold from :meth:`Collaboration.observe` (per-DTN ``rpc.*`` server
        counters, ``lease.*`` grant tables, ``meta.*``, ``sds.*``,
        ``replication.*``, ``faults.*``).  Keys are flat dotted metric
        names; histogram-valued metrics appear as snapshot dicts with
        ``p50``/``p99``.  This is the supported scrape surface — the
        per-subsystem ``*_stats()`` accessors below are retained as
        compatibility shims over the same registry data.
        """
        return self.plane.telemetry_fold()

    def rpc_stats(self) -> Dict[str, float]:
        """Deprecated shim — prefer :meth:`telemetry` (``rpc.*`` keys)."""
        return self.plane.rpc_stats()

    def cache_stats(self) -> Dict[str, int]:
        """Deprecated shim — prefer :meth:`telemetry` (``attrcache.*``)."""
        return self.plane.cache.stats()

    def resilience_stats(self) -> Dict[str, Any]:
        """Degraded-mode + breaker accounting (see ServicePlane).

        Deprecated shim — answers are folded from the same telemetry
        registry that backs :meth:`telemetry`; historical key names are
        preserved for existing callers.
        """
        return self.plane.resilience_stats()

    def data_stats(self) -> Dict[str, Any]:
        """Data-plane accounting: transfers, bytes, wire time, chunk-cache
        hit/miss/invalidation counters, prefetch activity.

        Deprecated shim — prefer :meth:`telemetry` (``datapath.*`` keys).
        """
        return self.datapath.stats()

    def close(self) -> None:
        self.datapath.close()
        self.plane.close()

    def crash(self) -> None:
        """Simulate this mount dying mid-session (nothing flushed); a new
        Workspace with the same ``journal_path`` recovers the acknowledged
        write-back updates and commits them on its next flush.  The chunk
        cache dies with the client — it is volatile client state."""
        self.datapath.close()
        self.plane.crash()


class NativeSession:
    """SCISPACE-LW: direct access to the local DC namespace (§III-B3).

    No FUSE layer, no metadata RPCs — the paper's native-data-access path.
    Files written here are invisible in the workspace until
    :class:`~repro_torch.core.meu.MEU` exports their metadata.
    """

    def __init__(self, dc: DataCenter, collaborator: str):
        self.dc = dc
        self.backend: StorageBackend = dc.backend
        self.collaborator = collaborator

    def write(self, path: str, data: bytes) -> int:
        path = _norm(path)
        n = self.backend.write(path, data, owner=self.collaborator)
        self._desync(path)
        return n

    def _desync(self, path: str) -> None:
        """A native (over)write de-synchronizes the file: if it was exported
        before, its metadata is stale until the next MEU export — which also
        re-publishes the invalidation that evicts remote chunk caches."""
        if self.backend.get_xattr(path, SYNC_XATTR) == "true":
            self.backend.set_xattr(path, SYNC_XATTR, "false")

    def create(self, path: str) -> None:
        self.backend.create(_norm(path), owner=self.collaborator)

    def read(self, path: str) -> bytes:
        return self.backend.read(_norm(path))

    def mkdir(self, path: str) -> None:
        self.backend.mkdir(_norm(path), owner=self.collaborator)

    def write_scidata(self, path: str, arrays: Dict[str, np.ndarray], attrs: Dict[str, Any]) -> int:
        path = _norm(path)
        n = _write_scidata_backend(
            self.backend, path, arrays, attrs, owner=self.collaborator
        )
        self._desync(path)
        return n

    def offline_index(self, paths: List[str], attr_filter: Optional[List[str]] = None) -> int:
        """LW-Offline extraction on the local DC's DTNs (§III-B5)."""
        return self.dc.offline_index([_norm(p) for p in paths], attr_filter)
