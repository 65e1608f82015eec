"""Scientific Discovery Service — SDS (§III-B5).

Attribute extraction + indexing + attribute-based search over the
collaboration workspace, with the paper's three extraction modes:

- **Inline-Sync** — extraction and indexing happen inside the write path;
  the write completes only after the attributes are in the discovery shard
  (strict consistency, highest write latency).
- **Inline-ASync** — the write enqueues a single small "index me" message;
  a background indexer dequeues and extracts later.  Draining is triggered by
  pre-defined thresholds (count / age), exactly the paper's "time, size and
  file count" thresholds, or explicitly.
- **LW-Offline** — for natively written (local-write) data: the indexer runs
  directly against the data-center namespace on the DTN, no FUSE/RPC in the
  write path at all.

Extraction reads only the self-describing header of a :mod:`scidata` file
(the HDF5 stand-in), filters by the collaborator-specified attribute list,
and records ``(attribute, file, value)`` rows in the discovery shard, plus
file-system stat attributes (pathname, size, mtime) the paper also indexes.
Manual tagging is supported (``tag``).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Sequence

from .backends import StorageBackend
from .metadata import DiscoveryShard
from .query import (
    Predicate,
    Query,
    SUMMARY_BITS,
    ShardSummary,
    parse_query,
    path_prefix_terms,
    summary_terms_for_row,
)
from .replication import AppliedMap, EpochClock, ReplicationLog
from .scidata import attr_type_of, read_header

__all__ = ["ExtractionMode", "DiscoveryService", "AsyncIndexer"]


class ExtractionMode:
    INLINE_SYNC = "inline-sync"
    INLINE_ASYNC = "inline-async"
    LW_OFFLINE = "lw-offline"
    NONE = "none"  # "if such an indexing is not required ... skip it"

    ALL = (INLINE_SYNC, INLINE_ASYNC, LW_OFFLINE, NONE)


def _value_columns(value: Any) -> Dict[str, Any]:
    t = attr_type_of(value)
    return {
        "attr_type": t,
        "value_int": int(value) if t == "int" else None,
        "value_real": float(value) if t == "float" else None,
        "value_text": value if t == "text" else None,
    }


class DiscoveryService:
    """RPC-facing discovery service of one DTN (owns one discovery shard).

    Replication roles: this shard is the **origin** of every row it extracts
    or tags (rows stamped ``origin=dtn_id`` with a fresh epoch, and logged
    for the ReplicaPump), and a **replica** for rows other shards shipped to
    it via ``apply_replicated_index`` — applied per ``(path, origin)`` with
    epoch last-writer-wins, so a re-extraction replaces exactly its own
    origin's earlier rows and never another shard's.
    """

    def __init__(
        self,
        shard: DiscoveryShard,
        *,
        dtn_id: int,
        backend: StorageBackend,
        clock: Optional[EpochClock] = None,
        log: Optional[ReplicationLog] = None,
        applied: Optional[AppliedMap] = None,
        mutation_lock: Optional[threading.RLock] = None,
        summary_bits: int = SUMMARY_BITS,
    ):
        self.shard = shard
        self.dtn_id = dtn_id
        self.backend = backend  # the DTN's data-center namespace
        self.extract_count = 0
        self.clock = clock if clock is not None else EpochClock()
        self.log = log
        #: per-origin applied watermark, shared DTN-wide with metadata
        self.applied = applied if applied is not None else AppliedMap()
        #: shared with the metadata service: log seq order == epoch order
        self._mutation_lock = mutation_lock if mutation_lock is not None else threading.RLock()
        #: (path, origin) -> last applied epoch (replacement-set granularity)
        self._applied_index: Dict[tuple, int] = {}
        self._apply_lock = threading.Lock()
        #: bloom summary over rows THIS shard originates — the planner prunes
        #: fan-outs against it (own-origin only: every row's origin shard is
        #: always a candidate, which is what keeps pruned unions complete)
        self.summary = ShardSummary(summary_bits)
        #: origin dtn_id -> that origin's summary, learned via replication
        #: (incrementally from applied index records, wholesale from "summary"
        #: records) so a client can prune against all shards by asking one DTN
        self._peer_summaries: Dict[int, ShardSummary] = {}
        #: origin dtn_id -> epoch its cached summary reflects
        self._peer_summary_epoch: Dict[int, int] = {}
        #: summary.version already replicated (dirty tracking for the pump)
        self._summary_logged_version = 0

    # -- indexing --------------------------------------------------------------
    def insert_attributes(self, rows: List[Dict[str, Any]], epoch: Optional[int] = None) -> int:
        """Record pre-extracted (path, name, value) rows (Inline-Sync path).

        Callers inside this service pass the mutation's ``epoch`` and log the
        replacement set themselves; a bare call (RPC surface) ticks and logs
        here so every local mutation epoch has a shippable record.
        """
        external = epoch is None
        if external:
            with self._mutation_lock:
                epoch = self.clock.tick()
                return self._insert_packed(rows, epoch, log_paths=True)
        return self._insert_packed(rows, epoch, log_paths=False)

    def _insert_packed(
        self, rows: List[Dict[str, Any]], epoch: int, *, log_paths: bool
    ) -> int:
        packed = []
        for r in rows:
            cols = _value_columns(r["value"])
            packed.append(
                (
                    r["path"],
                    r["name"],
                    cols["attr_type"],
                    cols["value_int"],
                    cols["value_real"],
                    cols["value_text"],
                    self.dtn_id,
                    epoch,
                )
            )
        n = self.shard.executemany(
            "INSERT INTO attributes(path,attr_name,attr_type,value_int,value_real,value_text,origin,epoch)"
            " VALUES(?,?,?,?,?,?,?,?)",
            packed,
        )
        for path, name, t, vi, vr, vt, _origin, _epoch in packed:
            self.summary.add_row(name, t, vi, vr, vt)
            self.summary.add_path(path)
        if log_paths:
            for path in dict.fromkeys(r["path"] for r in rows):
                self._log_index(path, epoch)
        return n

    # -- replication plumbing --------------------------------------------------
    def _own_rows(self, path: str) -> List[List[Any]]:
        """This origin's current raw rows for one path (replacement set)."""
        return [
            list(r)
            for r in self.shard.execute(
                "SELECT attr_name, attr_type, value_int, value_real, value_text"
                " FROM attributes WHERE path=? AND origin=?",
                (path, self.dtn_id),
            )
        ]

    def _log_index(self, path: str, epoch: int) -> None:
        """Log this origin's full row set for ``path`` as a replacement record.

        The set is one version: local rows from earlier epochs (e.g. a tag
        stacked on an extraction) are re-stamped to this epoch so origin and
        replicas hold byte-identical rows after the record applies.
        """
        self.shard.execute(
            "UPDATE attributes SET epoch=? WHERE path=? AND origin=?",
            (epoch, path, self.dtn_id),
        )
        if self.log is not None:
            self.log.append(
                {
                    "service": "sds",
                    "op": "index",
                    "path": path,
                    "rows": self._own_rows(path),
                    "epoch": epoch,
                    "origin": self.dtn_id,
                }
            )

    def _extract_rows(
        self,
        path: str,
        attr_filter: Optional[List[str]] = None,
        stat_size: Optional[int] = None,
    ) -> List[Dict[str, Any]]:
        """Read a file's self-describing header + stat into attribute rows."""
        rows: List[Dict[str, Any]] = []
        try:
            sci = read_header(self.backend, path)
            for name, value in sci.attrs.items():
                if attr_filter is None or name in attr_filter:
                    rows.append({"path": path, "name": name, "value": value})
        except (ValueError, FileNotFoundError, KeyError):
            pass  # not a self-describing file: index stat attributes only
        # file-system stat attributes (pathname, size, time) — §III-B5
        try:
            st = self.backend.stat(path)
            rows.append({"path": path, "name": "fs.size", "value": int(st.size)})
            rows.append({"path": path, "name": "fs.mtime", "value": float(st.mtime)})
            rows.append({"path": path, "name": "fs.path", "value": path})
        except FileNotFoundError:
            if stat_size is not None:
                rows.append({"path": path, "name": "fs.size", "value": int(stat_size)})
        return rows

    def extract_and_index(
        self,
        path: str,
        attr_filter: Optional[List[str]] = None,
        stat_size: Optional[int] = None,
    ) -> int:
        """Open the (scidata) file header, extract matching attrs, index them.

        This is the unit of work of every mode; the modes differ in *when and
        where* it runs relative to the write.
        """
        rows = self._extract_rows(path, attr_filter, stat_size)
        self.extract_count += 1
        with self._mutation_lock:
            epoch = self.clock.tick()
            # replace this origin's previous index rows for this file (a
            # replica copy of another shard's rows for the same path is left
            # intact)
            self.shard.execute(
                "DELETE FROM attributes WHERE path=? AND origin=?", (path, self.dtn_id)
            )
            n = self.insert_attributes(rows, epoch=epoch)
            self._log_index(path, epoch)
            return n

    def batch_index(self, paths: List[str], attr_filter: Optional[List[str]] = None) -> int:
        """Extract + index many files as one shard transaction (one RPC).

        The per-file work (header read, extraction) is unchanged; what
        collapses is the database contact pattern — one DELETE sweep and one
        multi-row INSERT instead of a statement pair per file — and, when
        called remotely, the channel round-trips.
        """
        paths = list(dict.fromkeys(paths))  # idempotent like extract_and_index
        if not paths:
            return 0
        with self._mutation_lock:
            return self._batch_index_locked(paths, attr_filter)

    def _batch_index_locked(
        self, paths: List[str], attr_filter: Optional[List[str]] = None
    ) -> int:
        epochs = {path: self.clock.tick() for path in paths}
        all_rows: List[tuple] = []
        for path in paths:
            for r in self._extract_rows(path, attr_filter):
                cols = _value_columns(r["value"])
                all_rows.append(
                    (
                        r["path"],
                        r["name"],
                        cols["attr_type"],
                        cols["value_int"],
                        cols["value_real"],
                        cols["value_text"],
                        self.dtn_id,
                        epochs[path],
                    )
                )
        self.extract_count += len(paths)
        self.shard.executemany(
            "DELETE FROM attributes WHERE path=? AND origin=?",
            [(p, self.dtn_id) for p in paths],
        )
        self.shard.executemany(
            "INSERT INTO attributes(path,attr_name,attr_type,value_int,value_real,value_text,origin,epoch)"
            " VALUES(?,?,?,?,?,?,?,?)",
            all_rows,
        )
        for path, name, t, vi, vr, vt, _origin, _epoch in all_rows:
            self.summary.add_row(name, t, vi, vr, vt)
            self.summary.add_path(path)
        for path in paths:
            self._log_index(path, epochs[path])
        return len(paths)

    def tag(self, path: str, name: str, value: Any) -> int:
        """Manual / collaborator-defined tagging (§III-B5)."""
        with self._mutation_lock:
            epoch = self.clock.tick()
            n = self.insert_attributes(
                [{"path": path, "name": name, "value": value}], epoch=epoch
            )
            self._log_index(path, epoch)
            return n

    # -- summary maintenance ---------------------------------------------------
    def log_summary_if_dirty(self) -> bool:
        """Replicate this shard's summary if bits flipped since the last ship.

        Rides the ordinary replication log as an ``op="summary"`` record —
        the pump's pre-drain hook calls this, so a summary change travels in
        the same drain as the index records that caused it.  No clock tick:
        a summary is derived state, not a namespace mutation (its epoch is
        the shard's last local mutation, which is exactly the freshness its
        bits reflect).
        """
        if self.log is None:
            return False
        with self._mutation_lock:
            if self.summary.version <= self._summary_logged_version:
                return False
            self._summary_logged_version = self.summary.version
            self.log.append(
                {
                    "service": "sds",
                    "op": "summary",
                    "path": "",
                    "epoch": self.clock.last_local(),
                    "origin": self.dtn_id,
                    "nbits": self.summary.nbits,
                    "bits": self.summary.to_message()["bits"],
                }
            )
            return True

    def summaries(self) -> Dict[str, Any]:
        """Every shard summary this DTN knows: its own plus replicated peers'.

        One RPC to any DTN gives a client the material to prune a global
        fan-out — the cheap "ask fewer peers" half of the wire-path work.
        Keys are origin dtn_ids (as strings, codec-safe); each value carries
        the summary bits plus the origin epoch they reflect.  The reply also
        carries this DTN's applied map: a peer filter here is complete
        through ``max(its epoch, applied[origin])`` — every record applied
        from an origin is folded into its cached filter — which is what lets
        a client judge each filter against its own session bar.
        """
        out: Dict[str, Any] = {
            str(self.dtn_id): dict(self.summary.to_message(), epoch=self.clock.last_local())
        }
        with self._apply_lock:
            for origin, summary in self._peer_summaries.items():
                out[str(origin)] = dict(
                    summary.to_message(), epoch=self._peer_summary_epoch.get(origin, 0)
                )
        return {"dtn_id": self.dtn_id, "summaries": out, "applied": self.applied_map()}

    def _note_peer_rows(self, origin: int, epoch: int, path: str, rows: Iterable) -> None:
        """Fold an applied index record into the cached peer summary."""
        summary = self._peer_summaries.get(origin)
        if summary is None:
            summary = self._peer_summaries[origin] = ShardSummary(self.summary.nbits)
        for name, t, vi, vr, vt in (tuple(r) for r in rows):
            summary.add_row(name, t, vi, vr, vt)
        summary.add_path(path)
        if epoch > self._peer_summary_epoch.get(origin, 0):
            self._peer_summary_epoch[origin] = epoch

    # -- replica role ----------------------------------------------------------
    def apply_replicated_index(self, records: List[Dict[str, Any]]) -> Dict[str, Any]:
        """Apply peer origins' replicated discovery records.

        Three record shapes, dispatched on ``op``:

        * ``index`` (default) — full replacement set per (path, origin),
          epoch last-writer-wins, idempotent under replay/reorder.
        * ``index_delta`` — row adds/removals against the previously shipped
          version (``base`` epoch).  Applied only when this replica's applied
          epoch for (path, origin) equals ``base``; otherwise the path lands
          in the returned ``need_full`` list and the sender re-ships the full
          set.  Removals are verified to exist *before* any mutation, so a
          delta either applies completely or not at all.
        * ``summary`` — wholesale refresh of the origin's shard summary.

        Watermarks: a compacted record's ``wm`` field (when present) bounds
        how far the per-origin AppliedMap may advance — the record's own
        epoch can sit *ahead* of still-unshipped earlier mutations when the
        sender coalesced a window, and claiming it early would let replica
        freshness checks pass before the data they vouch for has arrived.
        """
        applied = 0
        need_full: List[str] = []
        with self._apply_lock:
            for rec in records:
                op = rec.get("op", "index")
                origin = int(rec.get("origin", -1))
                epoch = int(rec.get("epoch", 0))
                self.clock.observe(epoch)
                if op != "index_delta":
                    # deltas advance the watermark only after they apply — a
                    # refused delta (need_full) must not let freshness checks
                    # vouch for rows that are still in flight
                    self.applied.advance(origin, int(rec.get("wm", epoch)))
                if op == "summary":
                    try:
                        summary = ShardSummary(nbits=int(rec["nbits"]), bits=bytes(rec["bits"]))
                    except (KeyError, ValueError):
                        continue  # malformed summary: ignorable derived state
                    self._peer_summaries[origin] = summary
                    if epoch > self._peer_summary_epoch.get(origin, 0):
                        self._peer_summary_epoch[origin] = epoch
                    applied += 1
                    continue
                path = rec["path"]
                key = (path, origin)
                if epoch <= self._applied_index.get(key, 0):
                    if op == "index_delta":  # replayed delta: already applied
                        self.applied.advance(origin, int(rec.get("wm", epoch)))
                    continue
                if op == "index_delta":
                    if self._applied_index.get(key, 0) != int(rec.get("base", -1)):
                        need_full.append(path)
                        continue
                    if not self._apply_delta(rec, path, origin, epoch):
                        need_full.append(path)
                        continue
                    self.applied.advance(origin, int(rec.get("wm", epoch)))
                    rows = list(rec.get("add") or [])
                else:
                    rows = list(rec.get("rows") or [])
                    self.shard.execute(
                        "DELETE FROM attributes WHERE path=? AND origin=?", (path, origin)
                    )
                    self.shard.executemany(
                        "INSERT INTO attributes(path,attr_name,attr_type,value_int,value_real,value_text,origin,epoch)"
                        " VALUES(?,?,?,?,?,?,?,?)",
                        [
                            (path, name, t, vi, vr, vt, origin, epoch)
                            for name, t, vi, vr, vt in (tuple(r) for r in rows)
                        ],
                    )
                self._applied_index[key] = epoch
                self._note_peer_rows(origin, epoch, path, rows)
                applied += 1
        return {"applied": applied, "need_full": need_full}

    def _apply_delta(self, rec: Dict[str, Any], path: str, origin: int, epoch: int) -> bool:
        """Apply one delta record; False means "cannot apply, need full".

        Removals are resolved to concrete rowids first (NULL-safe ``IS``
        comparisons; duplicates consume distinct rowids), so a stale or
        corrupt delta is rejected before the shard is touched.
        """
        removed_ids: List[int] = []
        taken = set()
        for row in rec.get("del") or []:
            name, t, vi, vr, vt = tuple(row)
            found = None
            for (rowid,) in self.shard.execute(
                "SELECT id FROM attributes WHERE path=? AND origin=? AND attr_name=?"
                " AND attr_type=? AND value_int IS ? AND value_real IS ? AND value_text IS ?",
                (path, origin, name, t, vi, vr, vt),
            ):
                if rowid not in taken:
                    found = rowid
                    break
            if found is None:
                return False
            taken.add(found)
            removed_ids.append(found)
        self.shard.executemany(
            "DELETE FROM attributes WHERE id=?", [(rowid,) for rowid in removed_ids]
        )
        self.shard.executemany(
            "INSERT INTO attributes(path,attr_name,attr_type,value_int,value_real,value_text,origin,epoch)"
            " VALUES(?,?,?,?,?,?,?,?)",
            [
                (path, name, t, vi, vr, vt, origin, epoch)
                for name, t, vi, vr, vt in (tuple(r) for r in rec.get("add") or [])
            ],
        )
        # the origin re-stamps every surviving row of the path to the record
        # epoch when it logs (one version per replacement set) — mirror that
        self.shard.execute(
            "UPDATE attributes SET epoch=? WHERE path=? AND origin=?", (epoch, path, origin)
        )
        return True

    def applied_map(self) -> Dict[str, int]:
        """Codec-safe applied-epoch map (origin dtn_id as str keys)."""
        return self.applied.snapshot()

    # -- anti-entropy surface (heal-time reconciliation) ----------------------
    def index_digest(self, prefix: str = "/") -> Dict[str, Dict[str, int]]:
        """Per-(path, origin) index-version watermarks under ``prefix``.

        ``{path: {origin: epoch}}`` (origins as str keys, codec-safe) — the
        max epoch over the shard's rows merged with the replica-apply
        bookkeeping (``_applied_index``), so a pair whose latest replacement
        set was *empty* still reports the version a replica applied.
        """
        like = prefix.rstrip("/") + "/%"
        out: Dict[str, Dict[str, int]] = {}
        for path, origin, epoch in self.shard.execute(
            "SELECT path, origin, MAX(epoch) FROM attributes"
            " WHERE path=? OR path LIKE ? GROUP BY path, origin",
            (prefix, like),
        ):
            out.setdefault(path, {})[str(int(origin))] = int(epoch)
        with self._apply_lock:
            applied = list(self._applied_index.items())
        for (path, origin), epoch in applied:
            if path != prefix and not path.startswith(prefix.rstrip("/") + "/"):
                continue
            cur = out.setdefault(path, {})
            if int(epoch) > cur.get(str(int(origin)), 0):
                cur[str(int(origin))] = int(epoch)
        return out

    def export_index_rows(self, path: str, origin: int) -> List[List[Any]]:
        """One (path, origin) replacement set, in the replicated-record row
        shape, for a heal-time diff replay."""
        return [
            list(r)
            for r in self.shard.execute(
                "SELECT attr_name, attr_type, value_int, value_real, value_text"
                " FROM attributes WHERE path=? AND origin=?",
                (path, int(origin)),
            )
        ]

    # -- async queue (Inline-ASync) ---------------------------------------------
    def enqueue_index(self, path: str, dc_id: str) -> bool:
        """The single small message the Inline-ASync write path sends."""
        self.shard.execute(
            "INSERT INTO pending_index(path,dc_id,enqueue_time) VALUES(?,?,?)",
            (path, dc_id, time.time()),
        )
        return True

    def pending_count(self) -> int:
        (n,) = self.shard.execute("SELECT COUNT(*) FROM pending_index")[0]
        return n

    def drain_pending(self, attr_filter: Optional[List[str]] = None, limit: int = -1) -> int:
        """Dequeue and index pending registrations (the async worker's body).

        The whole drain is one :meth:`batch_index` — a single shard
        transaction per DTN instead of a statement pair per file.  Duplicate
        registrations for the same path collapse into one extraction.
        """
        sql = "SELECT id, path FROM pending_index ORDER BY id"
        if limit > 0:
            sql += f" LIMIT {int(limit)}"
        rows = self.shard.execute(sql)
        if not rows:
            return 0
        unique_paths = list(dict.fromkeys(path for _, path in rows))
        self.batch_index(unique_paths, attr_filter)
        self.shard.executemany(
            "DELETE FROM pending_index WHERE id=?", [(row_id,) for row_id, _ in rows]
        )
        return len(rows)

    # -- search -------------------------------------------------------------------
    def query(self, text: str) -> List[str]:
        """Run a parsed query against this shard; returns matching paths."""
        q = parse_query(text)
        sql, params = q.to_sql()
        return [r[0] for r in self.shard.execute(sql, params)]

    def query_predicate(
        self, attr: str, op: str, value: Any, attr_type: str
    ) -> List[str]:
        """Predicate pushdown target for the scatter-gather planner.

        Evaluates ONE predicate against this shard and returns the matching
        path set; the planner unions these across shards and intersects
        across predicates centrally, so a file whose attribute rows are split
        over shards (e.g. tagged on one DTN, extracted on another) still
        matches conjunctions.
        """
        pred = Predicate(attr=attr, op=op, value=value, attr_type=attr_type)
        sql, params = pred.to_sql()
        return [r[0] for r in self.shard.execute(sql, params)]

    def scatter_query(self, predicates: List[Dict[str, Any]]) -> Dict[str, Any]:
        """One-round-trip scatter target for the query planner.

        Evaluates every predicate against this shard and returns the
        per-predicate match lists plus the attribute rows of every locally
        matched path, so the planner needs exactly one channel round-trip
        per shard for a full query + gather.
        """
        matches = [self.query_predicate(**p) for p in predicates]
        union = sorted({p for match in matches for p in match})
        return {
            "matches": matches,
            "rows": self.get_attrs(union),
            # replica-staleness accounting: what this shard has applied from
            # each origin, so a replica-local query can be judged fresh/stale
            "applied": self.applied_map(),
            "dtn_id": self.dtn_id,
            # summary piggyback: every reply refreshes the caller's pruning
            # cache for free (no extra RPC in the pruning protocol)
            "summary": self.summary.to_message(),
            "summary_epoch": self.clock.last_local(),
        }

    def get_attrs(self, paths: List[str]) -> List[Dict[str, Any]]:
        """Fetch full attribute rows for the given paths (gather phase)."""
        out: List[Dict[str, Any]] = []
        for path in paths:
            rows = self.shard.execute(
                "SELECT attr_name, attr_type, value_int, value_real, value_text"
                " FROM attributes WHERE path=?",
                (path,),
            )
            if not rows:
                continue
            attrs = {}
            for name, t, vi, vr, vt in rows:
                attrs[name] = vi if t == "int" else vr if t == "float" else vt
            out.append({"path": path, "attrs": attrs})
        return out

    def query_with_values(self, text: str) -> List[Dict[str, Any]]:
        """Query + return the matched files' full attribute rows (packed reply).

        The paper measures how reply size (hit-ratio) drives latency via
        message packing; returning full rows reproduces that effect.
        """
        return self.get_attrs(self.query(text))

    def stats(self) -> Dict[str, int]:
        (n_attr,) = self.shard.execute("SELECT COUNT(*) FROM attributes")[0]
        return {
            "attributes": n_attr,
            "pending": self.pending_count(),
            "extracted": self.extract_count,
            "dtn_id": self.dtn_id,
        }


class AsyncIndexer:
    """Background indexer thread for Inline-ASync mode.

    Drains a DTN's pending-index queue when either threshold fires:
    ``max_pending`` entries or ``max_age_s`` since the oldest registration
    (the paper's "pre-defined threshold such as time, size and file count").
    """

    def __init__(
        self,
        service: DiscoveryService,
        *,
        max_pending: int = 64,
        max_age_s: float = 0.5,
        attr_filter: Optional[List[str]] = None,
        poll_s: float = 0.02,
    ):
        self.service = service
        self.max_pending = max_pending
        self.max_age_s = max_age_s
        self.attr_filter = attr_filter
        self.poll_s = poll_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "AsyncIndexer":
        self._thread = threading.Thread(target=self._run, name="sds-async-indexer", daemon=True)
        self._thread.start()
        return self

    def _should_drain(self) -> bool:
        n = self.service.pending_count()
        if n == 0:
            return False
        if n >= self.max_pending:
            return True
        rows = self.service.shard.execute("SELECT MIN(enqueue_time) FROM pending_index")
        oldest = rows[0][0]
        return oldest is not None and (time.time() - oldest) >= self.max_age_s

    def _run(self) -> None:
        while not self._stop.is_set():
            if self._should_drain():
                self.service.drain_pending(self.attr_filter)
            self._stop.wait(self.poll_s)

    def stop(self, drain: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
        if drain:
            self.service.drain_pending(self.attr_filter)
