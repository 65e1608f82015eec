"""Distributed metadata management (§III-B2, Fig. 4).

Every DTN hosts two SQLite database shards (the paper's prototype uses SQLite
as the backend storage for each shard):

- the **metadata shard** — file-system metadata (filename, size, owner, path,
  data-center, namespace, the ``sync`` flag, and the pathname hash), updated
  *synchronously* on every workspace write;
- the **discovery shard** — indexing metadata: (attribute, file, value) rows
  extracted from scientific dataset headers plus user-defined tags, updated
  synchronously or asynchronously (§III-B5).

Files are placed onto DTNs by hashing the file pathname ("hash-based
placement strategy in order to eliminate the I/O broadcast problem when
multiple DTNs host metadata service").  Directory listings fan out to all
DTNs in parallel and merge.

The paper motivates a relational store over a key-value store because the
index needs many-to-many associations (one file ↔ many attributes); the
schema below keeps that property.
"""

from __future__ import annotations

import hashlib
import os
import sqlite3
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from .replication import AppliedMap, EpochClock, ReplicationLog

__all__ = [
    "hash_placement",
    "path_hash",
    "MetadataShard",
    "DiscoveryShard",
    "MetadataService",
]


def path_hash(path: str) -> str:
    """Stable pathname hash stored with each entry (Fig. 4 'File Mapping')."""
    return hashlib.blake2b(path.encode("utf-8"), digest_size=8).hexdigest()


def hash_placement(path: str, n_dtns: int) -> int:
    """Map a pathname onto the DTN that owns its metadata (§III-B1)."""
    if n_dtns <= 0:
        raise ValueError("need at least one DTN")
    return int(path_hash(path), 16) % n_dtns


# ---------------------------------------------------------------------------
# SQLite shards
# ---------------------------------------------------------------------------


class _SqliteShard:
    """One SQLite database file + a lock (SQLite serializes writers anyway)."""

    SCHEMA: Sequence[str] = ()

    def __init__(self, db_path: str):
        self.db_path = db_path
        if db_path != ":memory:":
            os.makedirs(os.path.dirname(db_path) or ".", exist_ok=True)
        self._conn = sqlite3.connect(db_path, check_same_thread=False)
        self._conn.execute("PRAGMA journal_mode=MEMORY")
        self._conn.execute("PRAGMA synchronous=OFF")
        self._lock = threading.Lock()
        with self._lock:
            for stmt in self.SCHEMA:
                self._conn.execute(stmt)
            self._conn.commit()

    def execute(self, sql: str, params: Sequence = ()) -> List[tuple]:
        with self._lock:
            cur = self._conn.execute(sql, params)
            rows = cur.fetchall()
            self._conn.commit()
            return rows

    def executemany(self, sql: str, rows: Iterable[Sequence]) -> int:
        with self._lock:
            cur = self._conn.executemany(sql, rows)
            self._conn.commit()
            return cur.rowcount

    def close(self) -> None:
        with self._lock:
            self._conn.close()


class MetadataShard(_SqliteShard):
    """File-system metadata + (replicated) namespace table — Fig. 4 left."""

    SCHEMA = (
        """CREATE TABLE IF NOT EXISTS files(
            path TEXT PRIMARY KEY,
            name TEXT NOT NULL,
            parent TEXT NOT NULL,
            size INTEGER NOT NULL DEFAULT 0,
            owner TEXT NOT NULL DEFAULT '',
            dc_id TEXT NOT NULL,
            dtn_id INTEGER NOT NULL,
            ns_id INTEGER NOT NULL DEFAULT 0,
            sync INTEGER NOT NULL DEFAULT 0,
            is_dir INTEGER NOT NULL DEFAULT 0,
            ctime REAL NOT NULL,
            mtime REAL NOT NULL,
            path_hash TEXT NOT NULL,
            epoch INTEGER NOT NULL DEFAULT 0,
            origin INTEGER NOT NULL DEFAULT -1
        )""",
        "CREATE INDEX IF NOT EXISTS idx_files_parent ON files(parent)",
        "CREATE INDEX IF NOT EXISTS idx_files_ns ON files(ns_id)",
        """CREATE TABLE IF NOT EXISTS namespaces(
            ns_id INTEGER PRIMARY KEY,
            name TEXT UNIQUE NOT NULL,
            scope TEXT NOT NULL,
            owner TEXT NOT NULL,
            prefix TEXT NOT NULL
        )""",
    )


class DiscoveryShard(_SqliteShard):
    """Indexing metadata: attribute rows + pending-index queue — Fig. 4 right."""

    SCHEMA = (
        """CREATE TABLE IF NOT EXISTS attributes(
            id INTEGER PRIMARY KEY AUTOINCREMENT,
            path TEXT NOT NULL,
            attr_name TEXT NOT NULL,
            attr_type TEXT NOT NULL,
            value_int INTEGER,
            value_real REAL,
            value_text TEXT,
            origin INTEGER NOT NULL DEFAULT -1,
            epoch INTEGER NOT NULL DEFAULT 0
        )""",
        "CREATE INDEX IF NOT EXISTS idx_attr_name ON attributes(attr_name)",
        "CREATE INDEX IF NOT EXISTS idx_attr_path ON attributes(path)",
        "CREATE INDEX IF NOT EXISTS idx_attr_origin ON attributes(path, origin)",
        """CREATE TABLE IF NOT EXISTS pending_index(
            id INTEGER PRIMARY KEY AUTOINCREMENT,
            path TEXT NOT NULL,
            dc_id TEXT NOT NULL,
            enqueue_time REAL NOT NULL
        )""",
    )


# ---------------------------------------------------------------------------
# Metadata service (one per DTN, reached over RPC)
# ---------------------------------------------------------------------------

_FILE_COLS = (
    "path",
    "name",
    "parent",
    "size",
    "owner",
    "dc_id",
    "dtn_id",
    "ns_id",
    "sync",
    "is_dir",
    "ctime",
    "mtime",
    "path_hash",
    "epoch",
    "origin",
)


def _row_to_entry(row: tuple) -> Dict[str, Any]:
    return dict(zip(_FILE_COLS, row))


class MetadataService:
    """RPC-facing facade over one DTN's metadata shard.

    Method signatures use only message-codec-safe types (see rpc.pack); this
    is the surface a gRPC .proto would describe.

    This DTN is the **origin** of every mutation it accepts over the normal
    surface: the op ticks the DTN's epoch clock, stamps the row with
    ``(epoch, origin=dtn_id)``, and appends a record to the replication log
    for the :class:`~repro_torch.core.replication.ReplicaPump` to ship.  The
    ``apply_replicated`` surface is the **replica** role: records from peer
    origins are applied with (epoch, origin) last-writer-wins and never
    re-logged (full-mesh pumps, no forwarding).
    """

    def __init__(
        self,
        shard: MetadataShard,
        *,
        dtn_id: int,
        dc_id: str,
        clock: Optional[EpochClock] = None,
        log: Optional[ReplicationLog] = None,
        applied: Optional[AppliedMap] = None,
        mutation_lock: Optional[threading.RLock] = None,
        leases: Optional[Any] = None,
    ):
        self.shard = shard
        self.dtn_id = dtn_id
        self.dc_id = dc_id
        self.clock = clock if clock is not None else EpochClock()
        self.log = log
        #: this DTN's LeaseTable (fence-floor authority); the lease_* methods
        #: below are its RPC surface so LeaseManagers can collect grants
        self.leases = leases
        #: per-origin applied watermark, shared DTN-wide with discovery
        self.applied = applied if applied is not None else AppliedMap()
        #: serializes tick -> mutate -> log across BOTH services of the DTN,
        #: so log seq order always matches epoch order — the property the
        #: pump's cursor and the replicas' AppliedMap watermark rely on
        self._mutation_lock = mutation_lock if mutation_lock is not None else threading.RLock()
        #: path -> (epoch, origin) of its unlink, so late upserts stay dead
        self._tombstones: Dict[str, Tuple[int, int]] = {}
        self._apply_lock = threading.Lock()

    # -- replication plumbing -------------------------------------------------
    def _log_record(self, op: str, **payload: Any) -> None:
        if self.log is not None:
            self.log.append(dict(payload, service="meta", op=op, origin=self.dtn_id))

    def _tombstoned(self, epoch: int, origin: int, path: str) -> bool:
        """Is ``path`` covered by an unlink tombstone newer than (epoch, origin)?

        An unlink removes the whole subtree, so its tombstone covers every
        descendant path — otherwise a child upsert racing the parent's
        unlink would apply on replicas that saw the unlink first but not on
        those that saw it second, and the tables would diverge on delivery
        order.
        """
        for tpath, stamp in self._tombstones.items():
            if (path == tpath or path.startswith(tpath.rstrip("/") + "/")) and (
                epoch, origin
            ) <= stamp:
                return True
        return False

    def _newer(self, epoch: int, origin: int, path: str) -> bool:
        """LWW: is (epoch, origin) newer than the stored row AND any tombstone?"""
        if self._tombstoned(epoch, origin, path):
            return False
        rows = self.shard.execute(
            "SELECT epoch, origin FROM files WHERE path=?", (path,)
        )
        return not rows or (epoch, origin) > (rows[0][0], rows[0][1])

    # -- FUSE-sequence ops (getattr, lookup, create, write/update, flush) ----
    def getattr(self, path: str) -> Optional[Dict[str, Any]]:
        rows = self.shard.execute(
            f"SELECT {','.join(_FILE_COLS)} FROM files WHERE path=?", (path,)
        )
        return _row_to_entry(rows[0]) if rows else None

    def lookup(self, path: str) -> bool:
        rows = self.shard.execute("SELECT 1 FROM files WHERE path=?", (path,))
        return bool(rows)

    def create(
        self,
        path: str,
        owner: str,
        dc_id: str,
        ns_id: int,
        is_dir: bool = False,
        sync: bool = True,
        size: int = 0,
    ) -> Dict[str, Any]:
        with self._mutation_lock:
            return self._create_locked(path, owner, dc_id, ns_id, is_dir, sync, size)

    def _create_locked(
        self,
        path: str,
        owner: str,
        dc_id: str,
        ns_id: int,
        is_dir: bool,
        sync: bool,
        size: int,
    ) -> Dict[str, Any]:
        now = time.time()
        name = path.rstrip("/").rsplit("/", 1)[-1] or "/"
        parent = path.rstrip("/").rsplit("/", 1)[0] or "/"
        entry = {
            "path": path,
            "name": name,
            "parent": parent,
            "size": size,
            "owner": owner,
            "dc_id": dc_id,
            "dtn_id": self.dtn_id,
            "ns_id": ns_id,
            "sync": 1 if sync else 0,
            "is_dir": 1 if is_dir else 0,
            "ctime": now,
            "mtime": now,
            "path_hash": path_hash(path),
            "epoch": self.clock.tick(),
            "origin": self.dtn_id,
        }
        self._tombstones.pop(path, None)  # a local re-create supersedes unlink
        self.shard.execute(
            f"INSERT OR REPLACE INTO files({','.join(_FILE_COLS)}) "
            f"VALUES({','.join('?' * len(_FILE_COLS))})",
            tuple(entry[c] for c in _FILE_COLS),
        )
        self._log_record("upsert", entries=[dict(entry)], epoch=entry["epoch"])
        return entry

    def update(
        self,
        path: str,
        size: Optional[int] = None,
        sync: Optional[bool] = None,
        fence_epoch: Optional[int] = None,
    ) -> bool:
        """Origin-role metadata update; epoch-stamped and logged.

        ``fence_epoch`` guards journal replays: the update applies only if
        the stored row is not newer than the epoch the (crashed) writer had
        witnessed when the update was acknowledged — otherwise a concurrent
        write that superseded it wins and the stale replay is dropped.
        """
        with self._mutation_lock:
            if fence_epoch is not None:
                rows = self.shard.execute("SELECT epoch FROM files WHERE path=?", (path,))
                if rows and rows[0][0] > fence_epoch:
                    return False
            now = time.time()
            epoch = self.clock.tick()
            sets, params = ["mtime=?", "epoch=?", "origin=?"], [now, epoch, self.dtn_id]
            if size is not None:
                sets.append("size=?")
                params.append(size)
            if sync is not None:
                sets.append("sync=?")
                params.append(1 if sync else 0)
            params.append(path)
            self.shard.execute(f"UPDATE files SET {','.join(sets)} WHERE path=?", params)
            # the record carries the origin's wall-clock mtime so replicas
            # apply byte-identical rows, not their own timestamps
            self._log_record(
                "update",
                path=path,
                epoch=epoch,
                mtime=now,
                size=size,
                sync=None if sync is None else (1 if sync else 0),
            )
            return True

    def delete(self, path: str) -> bool:
        with self._mutation_lock:
            epoch = self.clock.tick()
            self._tombstones[path] = (epoch, self.dtn_id)
            self.shard.execute(
                "DELETE FROM files WHERE path=? OR path LIKE ?", (path, path + "/%")
            )
            self._log_record("unlink", path=path, epoch=epoch)
            return True

    # -- MEU: one batched RPC commits many entries (§III-B3) -----------------
    def batch_upsert(self, entries: List[Dict[str, Any]]) -> int:
        with self._mutation_lock:
            return self._batch_upsert_locked(entries)

    def _batch_upsert_locked(self, entries: List[Dict[str, Any]]) -> int:
        rows = []
        logged: List[Dict[str, Any]] = []
        now = time.time()
        last_epoch = 0
        for e in entries:
            path = e["path"]
            name = path.rstrip("/").rsplit("/", 1)[-1] or "/"
            parent = path.rstrip("/").rsplit("/", 1)[0] or "/"
            last_epoch = self.clock.tick()
            entry = {
                "path": path,
                "name": name,
                "parent": parent,
                "size": int(e.get("size", 0)),
                "owner": e.get("owner", ""),
                "dc_id": e["dc_id"],
                "dtn_id": self.dtn_id,
                "ns_id": int(e.get("ns_id", 0)),
                "sync": int(e.get("sync", 1)),
                "is_dir": int(e.get("is_dir", 0)),
                "ctime": float(e.get("ctime", now)),
                "mtime": float(e.get("mtime", now)),
                "path_hash": path_hash(path),
                "epoch": last_epoch,
                "origin": self.dtn_id,
            }
            self._tombstones.pop(path, None)
            rows.append(tuple(entry[c] for c in _FILE_COLS))
            logged.append(entry)
        n = self.shard.executemany(
            f"INSERT OR REPLACE INTO files({','.join(_FILE_COLS)}) "
            f"VALUES({','.join('?' * len(_FILE_COLS))})",
            rows,
        )
        if logged:
            self._log_record("upsert", entries=logged, epoch=last_epoch)
        return n

    # -- replica role: apply a peer origin's records (LWW, idempotent) --------
    def apply_replicated(self, records: List[Dict[str, Any]]) -> int:
        """Apply epoch-stamped records shipped by a peer's ReplicaPump.

        Safe under replay, reorder and duplication: each row applies only
        when its ``(epoch, origin)`` exceeds what the shard already holds
        (including tombstones), and records are never re-logged.
        """
        applied = 0
        with self._apply_lock:
            for rec in records:
                op = rec.get("op")
                origin = int(rec.get("origin", -1))
                epoch = int(rec.get("epoch", 0))
                self.clock.observe(epoch)
                # delivery watermark: a record superseded by LWW still counts
                # as applied — the origin's history up to this epoch is here.
                # Compacted windows carry an explicit ``wm`` (the epoch the
                # sender has *fully* shipped): a coalesced record's own epoch
                # may sit ahead of still-unsent earlier mutations.
                self.applied.advance(origin, int(rec.get("wm", epoch)))
                if op == "upsert":
                    for entry in rec.get("entries") or []:
                        if not self._newer(int(entry["epoch"]), int(entry["origin"]), entry["path"]):
                            continue
                        self.shard.execute(
                            f"INSERT OR REPLACE INTO files({','.join(_FILE_COLS)}) "
                            f"VALUES({','.join('?' * len(_FILE_COLS))})",
                            tuple(entry[c] for c in _FILE_COLS),
                        )
                        applied += 1
                elif op == "update":
                    path = rec["path"]
                    if not self._newer(epoch, origin, path):
                        continue
                    sets, params = ["mtime=?", "epoch=?", "origin=?"], [
                        float(rec.get("mtime", time.time())), epoch, origin,
                    ]
                    if rec.get("size") is not None:
                        sets.append("size=?")
                        params.append(int(rec["size"]))
                    if rec.get("sync") is not None:
                        sets.append("sync=?")
                        params.append(int(rec["sync"]))
                    params.append(path)
                    self.shard.execute(
                        f"UPDATE files SET {','.join(sets)} WHERE path=?", params
                    )
                    applied += 1
                elif op == "unlink":
                    path = rec["path"]
                    tomb = self._tombstones.get(path)
                    if tomb is not None and (epoch, origin) <= tomb:
                        continue
                    self._tombstones[path] = (epoch, origin)
                    self.shard.execute(
                        "DELETE FROM files WHERE (path=? OR path LIKE ?) AND (epoch < ? OR (epoch = ? AND origin < ?))",
                        (path, path + "/%", epoch, epoch, origin),
                    )
                    applied += 1
        return applied

    # -- write leases (delegated to the DTN's LeaseTable) ---------------------
    def lease_grant(self, prefix: str, holder: str, ttl_s: float) -> Dict[str, Any]:
        if self.leases is None:
            raise RuntimeError("this DTN has no lease table")
        return self.leases.grant(prefix, holder, float(ttl_s))

    def lease_renew(self, prefix: str, holder: str, token: int, ttl_s: float) -> bool:
        if self.leases is None:
            raise RuntimeError("this DTN has no lease table")
        return self.leases.renew(prefix, holder, int(token), float(ttl_s))

    def lease_release(self, prefix: str, holder: str, token: int) -> bool:
        if self.leases is None:
            raise RuntimeError("this DTN has no lease table")
        return self.leases.release(prefix, holder, int(token))

    # -- anti-entropy surface (heal-time reconciliation) ----------------------
    def path_digest(self, prefix: str = "/") -> Dict[str, Any]:
        """Per-path (epoch, origin) watermarks under ``prefix``, plus live
        tombstones — the digest two sides exchange after a heal to find rows
        on which they diverge without shipping the rows themselves."""
        rows = self.shard.execute(
            "SELECT path, epoch, origin FROM files WHERE path=? OR path LIKE ?",
            (prefix, prefix.rstrip("/") + "/%"),
        )
        with self._apply_lock:
            tombs = {
                p: [int(e), int(o)]
                for p, (e, o) in self._tombstones.items()
                if p == prefix or p.startswith(prefix.rstrip("/") + "/")
            }
        return {
            "rows": {p: [int(e), int(o)] for p, e, o in rows},
            "tombs": tombs,
        }

    def export_entries(self, paths: List[str]) -> List[Dict[str, Any]]:
        """Full rows for a diff replay: byte-identical apply on the far side."""
        out = []
        for path in paths:
            rows = self.shard.execute(
                f"SELECT {','.join(_FILE_COLS)} FROM files WHERE path=?", (path,)
            )
            if rows:
                out.append(_row_to_entry(rows[0]))
        return out

    def getattr_replica(self, path: str, origin: int) -> Dict[str, Any]:
        """Replica-role read: the local row plus this shard's applied
        high-water mark for the path's origin DTN, so the caller can judge
        staleness against the epochs it has itself witnessed."""
        return {
            "entry": self.getattr(path),
            "applied": self.applied.get(origin),
            "epoch": self.clock.current(),
        }

    # -- listing with sync-flag + namespace-visibility semantics (§III-B1/B4)
    def _visibility_clause(self, requester: str) -> tuple:
        # A file is visible when its sync flag is set AND its namespace scope
        # is global, or the requester owns it / its namespace.
        sql = (
            "SELECT {cols} FROM files f LEFT JOIN namespaces n ON f.ns_id = n.ns_id "
            "WHERE f.sync=1 AND (n.scope IS NULL OR n.scope='global' "
            "OR f.owner=? OR n.owner=?)"
        ).format(cols=",".join("f." + c for c in _FILE_COLS))
        return sql, (requester, requester)

    def list_dir(self, parent: str, requester: str) -> List[Dict[str, Any]]:
        sql, params = self._visibility_clause(requester)
        sql += " AND f.parent=?"
        rows = self.shard.execute(sql, params + (parent,))
        return [_row_to_entry(r) for r in rows]

    def list_all(self, requester: str, prefix: str = "/") -> List[Dict[str, Any]]:
        sql, params = self._visibility_clause(requester)
        sql += " AND (f.path=? OR f.path LIKE ?)"
        rows = self.shard.execute(sql, params + (prefix, prefix.rstrip("/") + "/%"))
        return [_row_to_entry(r) for r in rows]

    # -- replica-role listings: entries + this shard's applied watermarks, so
    # the caller can judge whether the listing may miss writes it witnessed
    def applied_map(self) -> Dict[str, int]:
        return self.applied.snapshot()

    def list_dir_replica(self, parent: str, requester: str) -> Dict[str, Any]:
        return {"entries": self.list_dir(parent, requester), "applied": self.applied_map()}

    def list_all_replica(self, requester: str, prefix: str = "/") -> Dict[str, Any]:
        return {"entries": self.list_all(requester, prefix), "applied": self.applied_map()}

    # -- namespace table (replicated to every shard) --------------------------
    def put_namespace(self, ns_id: int, name: str, scope: str, owner: str, prefix: str) -> bool:
        self.shard.execute(
            "INSERT OR REPLACE INTO namespaces(ns_id,name,scope,owner,prefix) VALUES(?,?,?,?,?)",
            (ns_id, name, scope, owner, prefix),
        )
        return True

    def list_namespaces(self) -> List[Dict[str, Any]]:
        rows = self.shard.execute("SELECT ns_id,name,scope,owner,prefix FROM namespaces")
        return [dict(zip(("ns_id", "name", "scope", "owner", "prefix"), r)) for r in rows]

    # -- health/introspection -------------------------------------------------
    def stats(self) -> Dict[str, int]:
        (n_files,) = self.shard.execute("SELECT COUNT(*) FROM files")[0]
        (n_ns,) = self.shard.execute("SELECT COUNT(*) FROM namespaces")[0]
        return {"files": n_files, "namespaces": n_ns, "dtn_id": self.dtn_id}
