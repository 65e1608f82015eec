"""Asynchronous cross-DC metadata replication + crash-recoverable write-back.

The paper's metadata-export protocol (§III-B3) is an *asynchronous
replication channel* between native namespaces: a data center commits
metadata locally, and a background utility ships it to the collaboration —
"in a similar fashion to git local and remote repository management".  This
module generalizes that protocol from a one-shot utility into a standing
replication tier for the whole metadata plane:

- :class:`EpochClock` — a per-DTN Lamport clock.  Every local mutation
  ticks it; every message observed from a peer merges it.  A mutation is
  globally ordered by ``(epoch, origin_dtn)`` — last-writer-wins, the same
  resolution XUFS (arXiv:1001.0196) uses for write-back replay and the
  OSDF's origin/replica caches rely on for staleness accounting.
- :class:`ReplicationLog` — a per-DTN append-only log of epoch-stamped
  metadata mutations (file upsert / update / unlink, discovery index).
  This is the durable record the paper's MEU "single batched message" is
  built from, kept continuously instead of rebuilt by directory scans.
- :class:`ReplicaPump` — the asynchronous carrier.  A background worker
  (per DTN) drains that DTN's log to every peer DTN through the metadata
  plane's batched RPC (one ``apply_replicated`` batch per peer per drain),
  with the same count/age thresholds as the SDS
  :class:`~repro_torch.core.discovery.AsyncIndexer` — the paper's "pre-defined
  threshold such as time, size and file count" — bounding replica lag.
  Peers apply records with (epoch, origin) last-writer-wins, so replays,
  reorders and duplicate deliveries converge.
- :class:`WriteBackJournal` — the client half of durability.  The plane's
  write-back mode buffers the FUSE five-op "flush" update; the journal
  makes that buffer crash-recoverable: each deferred update is appended to
  an on-disk journal *before* the write is acknowledged, and
  :meth:`WriteBackJournal.recover` replays the buffered updates after a
  crash.  Count/age thresholds trigger the batched flush exactly like the
  AsyncIndexer's drain.

Roles fall out of placement: the DTN that owns a path's global hash is the
**origin** of its mutations; every other DTN holds an asynchronous
**replica** row stamped with the origin's epoch.  Readers (plane / query
planner) may serve from the nearest replica and fall back to the origin
when the replica has not yet applied the epochs the reader has witnessed
(session consistency: you always re-read your own acknowledged writes).
"""

from __future__ import annotations

import os
import struct
import threading
import time
from collections import Counter
from typing import TYPE_CHECKING, Any, Dict, List, Optional, Tuple

from .faults import TornWrite
from .rpc import RpcError, pack, unpack

if TYPE_CHECKING:  # pragma: no cover - type-only imports
    from .cluster import Collaboration, DTN

__all__ = [
    "AntiEntropyReconciler",
    "AppliedMap",
    "AdaptiveBatcher",
    "EpochClock",
    "ReplicationLog",
    "ReplicaPump",
    "WriteBackJournal",
    "compact_window",
    "WB_MAX_PENDING",
    "WB_MAX_AGE_S",
    "PUMP_MAX_PENDING",
    "PUMP_MAX_AGE_S",
    "COMPACT_WINDOW",
    "RECONCILE_PREFIX",
    "RECONCILE_TIMEOUT_S",
]

#: write-back journal flush thresholds (mirroring AsyncIndexer's defaults;
#: the testbed config re-exports these so benchmarks tune them in one place)
WB_MAX_PENDING = 64
WB_MAX_AGE_S = 0.5
#: replication pump drain thresholds (bounded replica lag)
PUMP_MAX_PENDING = 64
PUMP_MAX_AGE_S = 0.05
#: max raw records one drain coalesces per peer (the compaction window)
COMPACT_WINDOW = 512
#: anti-entropy defaults (configs/scispace_testbed.py re-exports these):
#: namespace subtree a heal-time reconcile sweeps, and how long it may wait
#: for the pumps to quiesce before digest exchange
RECONCILE_PREFIX = "/"
RECONCILE_TIMEOUT_S = 10.0


class EpochClock:
    """Thread-safe Lamport clock; epochs are positive, 0 means "never".

    Two readings: :meth:`current` is the merged Lamport value (ordering —
    what ticks must exceed), :meth:`last_local` is the epoch of this node's
    own most recent *mutation*.  Freshness bars use ``last_local``: a
    replica has caught up with an origin when it has applied the origin's
    mutations, not when it has heard epochs the origin merely observed from
    others (those inflate ``current`` without producing any record to ship).
    """

    def __init__(self, start: int = 0):
        self._value = int(start)
        self._last_local = 0
        self._lock = threading.Lock()

    def current(self) -> int:
        with self._lock:
            return self._value

    def last_local(self) -> int:
        with self._lock:
            return self._last_local

    def tick(self) -> int:
        """Advance for a local mutation; returns the mutation's epoch."""
        with self._lock:
            self._value += 1
            self._last_local = self._value
            return self._value

    def observe(self, epoch: int) -> int:
        """Merge an epoch seen in a message (Lamport receive rule)."""
        with self._lock:
            if epoch > self._value:
                self._value = int(epoch)
            return self._value


class AppliedMap:
    """Per-origin high-water mark of replicated epochs applied at one DTN.

    Shared by the DTN's metadata and discovery services: both feed one log
    (one clock, epochs monotone in log order), so a single watermark per
    origin states "every mutation of this origin up to epoch E has been
    applied here" regardless of which service the mutation touched.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._epochs: Dict[int, int] = {}

    def advance(self, origin: int, epoch: int) -> None:
        with self._lock:
            if epoch > self._epochs.get(origin, 0):
                self._epochs[origin] = int(epoch)

    def get(self, origin: int) -> int:
        with self._lock:
            return self._epochs.get(origin, 0)

    def snapshot(self) -> Dict[str, int]:
        """Codec-safe copy (str origin keys for the message layer)."""
        with self._lock:
            return {str(o): e for o, e in self._epochs.items()}


class ReplicationLog:
    """Per-DTN append-only log of epoch-stamped metadata mutations.

    Records are codec-safe dicts carrying at least ``service`` ("meta" or
    "sds"), ``op``, ``epoch``, ``origin`` and a payload; :meth:`append`
    assigns the monotonically increasing ``seq`` and timestamps the record.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._records: List[Dict[str, Any]] = []
        self._base_seq = 0  # seq of the first retained record minus one
        self.appended = 0

    def append(self, record: Dict[str, Any]) -> int:
        with self._lock:
            seq = self._base_seq + len(self._records) + 1
            record = dict(record, seq=seq, t=time.time())
            self._records.append(record)
            self.appended += 1
            return seq

    def last_seq(self) -> int:
        with self._lock:
            return self._base_seq + len(self._records)

    def since(self, seq: int, limit: int = -1) -> List[Dict[str, Any]]:
        """Records with ``seq`` strictly greater than the cursor, in order."""
        with self._lock:
            start = max(0, seq - self._base_seq)
            out = self._records[start:]
            if limit > 0:
                out = out[:limit]
            return [dict(r) for r in out]

    def pending_for(self, seq: int) -> int:
        return max(0, self.last_seq() - seq)

    def oldest_age_for(self, seq: int) -> float:
        """Age of the oldest record a cursor has not yet shipped."""
        with self._lock:
            start = max(0, seq - self._base_seq)
            if start >= len(self._records):
                return 0.0
            return time.time() - self._records[start]["t"]

    def truncate_upto(self, seq: int) -> int:
        """Drop records every consumer has shipped (``seq`` = min cursor)."""
        with self._lock:
            drop = min(max(0, seq - self._base_seq), len(self._records))
            if drop:
                del self._records[:drop]
                self._base_seq += drop
            return drop


def _max_epoch(rec: Dict[str, Any]) -> int:
    """Highest epoch a (possibly multi-entry) record carries."""
    epoch = int(rec.get("epoch", 0))
    for entry in rec.get("entries") or []:
        epoch = max(epoch, int(entry.get("epoch", 0)))
    return epoch


def compact_window(records: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Coalesce one drain window so only the last writer per path survives.

    Input is a contiguous, seq-ordered slice of one DTN's log (epochs are
    monotone in seq because the DTN's mutation lock serializes tick → mutate
    → log).  Rules, per path:

    * later ``upsert`` entries replace earlier ones wholesale;
    * an ``update`` folds into an earlier in-window ``upsert`` of the same
      path (field-wise: the update's non-None fields and epoch win) and
      merges field-wise with earlier in-window updates;
    * ``unlink`` subsumes every earlier in-window record for the path *and*
      its subtree, but the unlink itself is **always shipped** — the replica
      needs the tombstone, and rows from earlier windows still need deleting.
      Records after the unlink (a re-create) survive on their own;
    * ``index`` (sds) and ``summary`` replacement records keep last-per-key.

    Convergence is byte-identical to shipping the raw window: every dropped
    record is superseded, within the window, by a shipped record the
    replica's (epoch, origin) LWW would have preferred anyway.  This relies
    on hash placement giving each path a single origin DTN — the log being
    compacted only ever holds one writer's history per path.

    Output is seq-ordered (a merged record takes its last contributor's
    seq); adjacent surviving meta upserts are re-grouped into multi-entry
    records so coalescing never multiplies record framing overhead.
    """
    # path -> (sort_seq, record) for coalescable slots; unlinks/others append-only
    meta_slots: Dict[str, Tuple[int, Dict[str, Any]]] = {}
    sds_slots: Dict[str, Tuple[int, Dict[str, Any]]] = {}
    summary_slot: Dict[int, Tuple[int, Dict[str, Any]]] = {}
    keep: List[Tuple[int, Dict[str, Any]]] = []

    def _drop_subtree(prefix_path: str) -> None:
        sub = prefix_path.rstrip("/") + "/"
        for path in [p for p in meta_slots if p == prefix_path or p.startswith(sub)]:
            del meta_slots[path]

    for rec in records:
        service, op, seq = rec.get("service"), rec.get("op"), int(rec["seq"])
        if service == "meta" and op == "upsert":
            for entry in rec.get("entries") or []:
                single = dict(rec, entries=[dict(entry)], epoch=int(entry["epoch"]))
                meta_slots[entry["path"]] = (seq, single)
        elif service == "meta" and op == "update":
            path = rec["path"]
            prev = meta_slots.get(path)
            if prev is not None and prev[1].get("op") == "upsert":
                entry = dict(prev[1]["entries"][0])
                entry["epoch"] = int(rec["epoch"])
                entry["mtime"] = float(rec.get("mtime", entry.get("mtime", 0.0)))
                if rec.get("size") is not None:
                    entry["size"] = int(rec["size"])
                if rec.get("sync") is not None:
                    entry["sync"] = int(rec["sync"])
                meta_slots[path] = (seq, dict(prev[1], entries=[entry], epoch=entry["epoch"], seq=seq))
            elif prev is not None:  # update-over-update: later non-None fields win
                merged = dict(prev[1])
                merged.update({k: v for k, v in rec.items() if v is not None})
                meta_slots[path] = (seq, merged)
            else:
                meta_slots[path] = (seq, dict(rec))
        elif service == "meta" and op == "unlink":
            _drop_subtree(rec["path"])
            keep.append((seq, dict(rec)))
        elif service == "sds" and op in ("index", "index_delta"):
            sds_slots[rec["path"]] = (seq, dict(rec))
        elif service == "sds" and op == "summary":
            summary_slot[int(rec.get("origin", -1))] = (seq, dict(rec))
        else:  # unknown shape: ship verbatim, never guess
            keep.append((seq, dict(rec)))

    out = keep + list(meta_slots.values()) + list(sds_slots.values()) + list(summary_slot.values())
    out.sort(key=lambda item: item[0])

    # re-group adjacent surviving upserts into multi-entry records (framing
    # overhead back to one record per contiguous run, like batch_upsert logs)
    grouped: List[Dict[str, Any]] = []
    for _seq, rec in out:
        if (
            grouped
            and rec.get("service") == "meta"
            and rec.get("op") == "upsert"
            and grouped[-1].get("service") == "meta"
            and grouped[-1].get("op") == "upsert"
        ):
            prev_rec = grouped[-1]
            prev_rec["entries"] = list(prev_rec["entries"]) + list(rec["entries"])
            prev_rec["epoch"] = max(int(prev_rec["epoch"]), int(rec["epoch"]))
            prev_rec["seq"] = max(int(prev_rec["seq"]), int(rec["seq"]))
        else:
            grouped.append(rec)
    return grouped


class AdaptiveBatcher:
    """Adapts the pump's drain window from observed per-record drain latency.

    An EWMA over ``elapsed / records`` estimates the marginal cost of one
    more record in a drain; the window is then sized so a whole drain lands
    near ``target_s`` — long windows (more coalescing, fewer RPCs) on fast
    links, short windows (bounded lag) on slow ones.  Clamped to
    ``[lo, hi]``; starts at ``initial`` until the first observation.
    """

    def __init__(
        self,
        initial: int = COMPACT_WINDOW,
        *,
        lo: int = 32,
        hi: int = 4096,
        target_s: float = 0.05,
        alpha: float = 0.3,
    ):
        if not (0 < lo <= initial <= hi):
            raise ValueError(f"need lo <= initial <= hi, got {lo}/{initial}/{hi}")
        self.lo, self.hi, self.target_s, self.alpha = lo, hi, target_s, alpha
        self.window = int(initial)
        self._per_record: Optional[float] = None
        self.observations = 0

    def record(self, n_records: int, elapsed_s: float) -> int:
        """Feed one drain's (records shipped, wall seconds); returns window."""
        if n_records > 0 and elapsed_s >= 0:
            per = elapsed_s / n_records
            self._per_record = (
                per
                if self._per_record is None
                else self.alpha * per + (1 - self.alpha) * self._per_record
            )
            self.observations += 1
            if self._per_record > 0:
                self.window = max(self.lo, min(self.hi, int(self.target_s / self._per_record)))
        return self.window


class ReplicaPump:
    """Drains one DTN's replication log to every peer DTN, asynchronously.

    The carrier is the metadata plane's batched RPC: per drain, each peer
    receives at most one ``apply_replicated`` batch (metadata records) and
    one ``apply_replicated_index`` batch (discovery records), all peers in
    flight concurrently with the plane's bounded fan-out.  A peer that is
    down (``RpcError``) simply keeps its cursor; the next drain retries, so
    a restarted DTN recovers the records it missed without a special path.
    """

    def __init__(
        self,
        dtn: "DTN",
        collab: "Collaboration",
        *,
        max_pending: int = PUMP_MAX_PENDING,
        max_age_s: float = PUMP_MAX_AGE_S,
        poll_s: float = 0.01,
        batch_limit: int = COMPACT_WINDOW,
        compact: bool = True,
        deltas: bool = True,
        adaptive_batch: bool = False,
    ):
        from .plane import ServicePlane  # local import: plane imports nothing from here

        self.dtn = dtn
        self.collab = collab
        self.log = dtn.replication_log
        self.max_pending = max_pending
        self.max_age_s = max_age_s
        self.poll_s = poll_s
        self.batch_limit = batch_limit
        self.compact = compact
        self.deltas = deltas
        self.batcher: Optional[AdaptiveBatcher] = (
            AdaptiveBatcher(batch_limit) if adaptive_batch else None
        )
        self.plane = ServicePlane(collab, dtn.dc_id, subscribe=False)
        self._cursors: Dict[int, int] = {}  # peer dtn_id -> last seq shipped
        #: peer dtn_id -> highest epoch fully shipped (the wm stamped on
        #: non-final window records, so partial windows never inflate the
        #: receiver's AppliedMap)
        self._peer_wm: Dict[int, int] = {}
        #: peer dtn_id -> {path: (epoch, row-tuple multiset base)} — the last
        #: index replacement set shipped there, the base deltas encode against
        self._shipped_idx: Dict[int, Dict[str, Tuple[int, List[tuple]]]] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.records_shipped = 0
        self.records_compacted = 0
        self.delta_records = 0
        self.delta_refused = 0
        self.drains = 0
        self.send_errors = 0

    # -- lag accounting --------------------------------------------------------
    def _peers(self, include_down: bool = True) -> List[int]:
        return [
            d.dtn_id
            for d in self.collab.dtns
            if d.dtn_id != self.dtn.dtn_id and (include_down or not d.down)
        ]

    def min_cursor(self, include_down: bool = True) -> int:
        """Slowest peer's cursor.  Log truncation must include down peers
        (their records are still owed); lag/quiesce accounting must not, or
        one crashed DTN makes the lag unbounded."""
        peers = self._peers(include_down)
        if not peers:
            return self.log.last_seq()
        with self._lock:
            return min(self._cursors.get(p, 0) for p in peers)

    def lag(self) -> int:
        """Records the slowest *reachable* peer has not applied yet."""
        return self.log.pending_for(self.min_cursor(include_down=False))

    def _should_drain(self) -> bool:
        behind = self.min_cursor(include_down=False)
        if self.log.pending_for(behind) >= self.max_pending:
            return True
        age = self.log.oldest_age_for(behind)
        return age > 0 and age >= self.max_age_s

    # -- the drain body --------------------------------------------------------
    def _encode_for_peer(
        self, peer: int, ship: List[Dict[str, Any]]
    ) -> Tuple[List[Dict[str, Any]], Dict[str, Dict[str, Any]], Dict[str, Tuple[int, List[tuple]]], int]:
        """Watermark-stamp a compacted window and delta-encode index records.

        Returns ``(records, full_by_path, staged_bases, window_max)``:
        ``full_by_path`` holds the full replacement record for every path
        shipped as a delta (the ``need_full`` fallback), ``staged_bases`` the
        per-path bases to commit into :attr:`_shipped_idx` once the window
        fully lands.
        """
        wm_prev = self._peer_wm.get(peer, 0)
        window_max = max((_max_epoch(r) for r in ship), default=wm_prev)
        bases = self._shipped_idx.setdefault(peer, {})
        out: List[Dict[str, Any]] = []
        full_by_path: Dict[str, Dict[str, Any]] = {}
        staged: Dict[str, Tuple[int, List[tuple]]] = {}
        last = len(ship) - 1
        for i, rec in enumerate(ship):
            rec = dict(rec, wm=window_max if i == last else wm_prev)
            if rec.get("service") == "sds" and rec.get("op") == "index":
                path = rec["path"]
                rows = [tuple(r) for r in rec.get("rows") or []]
                staged[path] = (int(rec["epoch"]), rows)
                base = bases.get(path)
                # the final record carries the window watermark and must
                # never be refused (need_full would leave the watermark
                # claiming rows the replica does not hold yet), so it always
                # ships full
                if self.deltas and base is not None and i != last:
                    base_epoch, base_rows = base
                    want, have = Counter(rows), Counter(base_rows)
                    add = list((want - have).elements())
                    remove = list((have - want).elements())
                    if len(add) + len(remove) < len(rows):
                        full_by_path[path] = rec
                        rec = {
                            "service": "sds",
                            "op": "index_delta",
                            "path": path,
                            "base": base_epoch,
                            "add": [list(r) for r in add],
                            "del": [list(r) for r in remove],
                            "epoch": rec["epoch"],
                            "origin": rec["origin"],
                            "seq": rec["seq"],
                            "wm": rec["wm"],
                        }
                        self.delta_records += 1
            out.append(rec)
        return out, full_by_path, staged, window_max

    def _ship_window(self, peer: int, records: List[Dict[str, Any]], full_by_path: Dict[str, Dict[str, Any]]) -> bool:
        """Ship one window as same-service runs in log order; True iff all landed."""
        runs: List[Tuple[str, List[Dict[str, Any]]]] = []
        for r in records:
            if runs and runs[-1][0] == r.get("service"):
                runs[-1][1].append(r)
            else:
                runs.append((r.get("service"), [r]))
        for service, run in runs:
            method = "apply_replicated" if service == "meta" else "apply_replicated_index"
            try:
                reply = self.plane.call(service, peer, method, records=run)
            except RpcError:
                self.send_errors += 1
                return False
            need_full = (reply or {}).get("need_full") if isinstance(reply, dict) else None
            if need_full:
                # the replica's base diverged (crash/restore, missed state):
                # re-ship those paths as full replacement sets immediately
                self.delta_refused += len(need_full)
                reships = [full_by_path[p] for p in need_full if p in full_by_path]
                if len(reships) != len(need_full):
                    return False  # a path we cannot re-ship: keep the cursor
                try:
                    self.plane.call(service, peer, method, records=reships)
                except RpcError:
                    self.send_errors += 1
                    return False
        return True

    def drain(self) -> int:
        """Ship pending records to every lagging peer; returns records sent.

        Per peer: take the unshipped window (bounded by the compaction
        window / adaptive batcher), coalesce it with :func:`compact_window`,
        delta-encode index records against the previously shipped version,
        and ship as contiguous same-service runs **in log order** (metadata
        and discovery records interleave on one log but target different
        servers).  The window is all-or-nothing per peer: the cursor, the
        shipped-watermark and the delta bases advance only when every run
        (and every ``need_full`` re-ship) landed — a compacted record can
        merge several raw mutations, so there is no meaningful "partially
        applied" cursor position inside a window.
        """
        self.dtn.discovery.log_summary_if_dirty()
        sent_total = 0
        for p in self._peers():
            with self._lock:
                cur = self._cursors.get(p, 0)
            limit = self.batcher.window if self.batcher is not None else self.batch_limit
            recs = self.log.since(cur, limit=limit)
            if not recs:
                continue
            t0 = time.perf_counter()
            window_end = int(recs[-1]["seq"])
            ship = compact_window(recs) if self.compact else [dict(r) for r in recs]
            self.records_compacted += len(recs) - len(ship)
            records, full_by_path, staged, window_max = self._encode_for_peer(p, ship)
            # the pump thread has no foreground context: each window roots its
            # own trace, and the ship RPCs (the pump plane's clients carry the
            # same tracer) land as rpc.*/apply.* children under it
            tracer = self.plane.telemetry.tracer
            with tracer.span("pump.ship", peer=p, n=len(records)) as sp:
                shipped = self._ship_window(p, records, full_by_path)
                if not shipped and sp is not None:
                    sp.status = "error"
            if not shipped:
                continue
            with self._lock:
                if window_end > self._cursors.get(p, 0):
                    sent_total += window_end - self._cursors.get(p, 0)
                    self._cursors[p] = window_end
                self._peer_wm[p] = max(self._peer_wm.get(p, 0), window_max)
                self._shipped_idx.setdefault(p, {}).update(staged)
            if self.batcher is not None:
                self.batcher.record(len(recs), time.perf_counter() - t0)
        self.records_shipped += sent_total
        self.drains += 1
        self.log.truncate_upto(self.min_cursor(include_down=True))
        return sent_total

    def quiesce(self, timeout_s: float = 10.0) -> bool:
        """Drain until every reachable peer has everything (or timeout)."""
        deadline = time.time() + timeout_s
        while self.lag() > 0:
            if time.time() > deadline:
                # honor the deadline even while progressing — a concurrent
                # writer (or a flapping peer re-entering the reachable set)
                # can otherwise keep "progress" alive forever
                return False
            before = self.min_cursor(include_down=False)
            self.drain()
            if self.min_cursor(include_down=False) == before:
                if time.time() > deadline:
                    return False
                time.sleep(self.poll_s)  # no progress: back off, don't spin
        return True

    # -- worker lifecycle ------------------------------------------------------
    def start(self) -> "ReplicaPump":
        # the thread is started before it is published, under the lock that
        # stop() reads it under: a concurrent stop() never joins a thread
        # that has not started.  Each thread has its own stop event, so a
        # start() right after a stop() cannot revive the thread being stopped
        with self._lock:
            if self._thread is None:
                stop = threading.Event()
                thread = threading.Thread(
                    target=self._run, args=(stop,), name=f"replica-pump-dtn{self.dtn.dtn_id}", daemon=True
                )
                thread.start()
                self._thread, self._stop = thread, stop
        return self

    def _run(self, stop: threading.Event) -> None:
        while not stop.is_set():
            if self._should_drain():
                self.drain()
            stop.wait(self.poll_s)

    def stop(self, drain: bool = True) -> None:
        with self._lock:
            self._stop.set()
            thread, self._thread = self._thread, None
        if thread is not None:
            # a fault-plane crash can fire from inside this pump's own drain
            # (the Nth served call was one of ours) — joining ourselves would
            # deadlock, and the _stop flag already ends the loop on return
            if thread is not threading.current_thread():
                thread.join(timeout=10)
        if drain:
            self.drain()

    def bytes_shipped(self) -> int:
        """Wire bytes this pump's own clients pushed (requests only)."""
        return sum(c.stats.bytes_sent for c in self.plane.clients())

    def stats(self) -> Dict[str, float]:
        return {
            "dtn_id": self.dtn.dtn_id,
            "lag_records": self.lag(),
            "records_shipped": self.records_shipped,
            "records_compacted": self.records_compacted,
            "delta_records": self.delta_records,
            "delta_refused": self.delta_refused,
            "bytes_shipped": self.bytes_shipped(),
            "window": self.batcher.window if self.batcher is not None else self.batch_limit,
            "drains": self.drains,
            "send_errors": self.send_errors,
        }


# ---------------------------------------------------------------------------
# Client-side write-back journal
# ---------------------------------------------------------------------------

_JOURNAL_MAGIC = b"WBJ1"


class WriteBackJournal:
    """Crash-recoverable buffer of deferred metadata updates.

    Disk layout: a 4-byte magic header, then length-prefixed packed records
    ``{"path", "kw", "epoch", "t"}``.  A record is on disk *before* the
    write is acknowledged, so a crash between acknowledgement and flush
    loses nothing; a torn final record (crash mid-append) is discarded on
    recovery.  ``path=None`` keeps the journal purely in memory (the
    pre-journal behavior, for throwaway planes).
    """

    def __init__(
        self,
        path: Optional[str] = None,
        *,
        max_pending: int = WB_MAX_PENDING,
        max_age_s: float = WB_MAX_AGE_S,
        fault_hook: Optional[Any] = None,
    ):
        self.path = path
        self.max_pending = max_pending
        self.max_age_s = max_age_s
        #: fault-plane seam: called with each append's frame length, returns
        #: how many bytes actually reach the disk (None = intact write)
        self._fault_hook = fault_hook
        self._lock = threading.Lock()
        self._pending: Dict[str, Dict[str, Any]] = {}
        self._fences: Dict[str, int] = {}
        self._first_dirty_t: Optional[float] = None
        self._file_dirty = False
        self._fh = None
        if path is not None:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            fresh = not os.path.exists(path) or os.path.getsize(path) == 0
            if not fresh:
                # drop a torn tail (predecessor crashed mid-append) BEFORE
                # appending, or our records would land behind unreadable
                # bytes and be invisible to the next recovery
                _, valid_end = self._scan(path)
                os.truncate(path, valid_end)
                fresh = valid_end == 0
            self._fh = open(path, "ab")
            if fresh:
                self._fh.write(_JOURNAL_MAGIC)
                self._fh.flush()
                os.fsync(self._fh.fileno())

    # -- append / thresholds ---------------------------------------------------
    def append(self, path: str, kw: Dict[str, Any], epoch: int = 0) -> None:
        """Record one deferred update durably; merges with earlier ones."""
        with self._lock:
            self._pending.setdefault(path, {}).update(kw)
            if self._first_dirty_t is None:
                self._first_dirty_t = time.time()
            if self._fh is not None:
                payload = pack({"path": path, "kw": dict(kw), "epoch": epoch, "t": time.time()})
                frame = struct.pack("<I", len(payload)) + payload
                keep = self._fault_hook(len(frame)) if self._fault_hook is not None else None
                if keep is not None and keep < len(frame):
                    # injected torn write: a prefix lands durably, then the
                    # device fails mid-fsync — recovery must discard the tail
                    self._fh.write(frame[:keep])
                    self._fh.flush()
                    os.fsync(self._fh.fileno())
                    self._file_dirty = True
                    raise TornWrite(
                        f"journal append torn after {keep}/{len(frame)} bytes (injected)"
                    )
                self._fh.write(frame)
                self._fh.flush()
                os.fsync(self._fh.fileno())
                self._file_dirty = True

    def pending_count(self) -> int:
        with self._lock:
            return len(self._pending)

    def oldest_age(self) -> float:
        with self._lock:
            return 0.0 if self._first_dirty_t is None else time.time() - self._first_dirty_t

    def should_flush(self) -> bool:
        """Either threshold fired: buffered-path count or oldest-entry age."""
        with self._lock:
            if not self._pending:
                return False
            if len(self._pending) >= self.max_pending:
                return True
            return (
                self._first_dirty_t is not None
                and (time.time() - self._first_dirty_t) >= self.max_age_s
            )

    def pending(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            return {p: dict(kw) for p, kw in self._pending.items()}

    def ack(self, path: str) -> None:
        """One path's record is quorum-durable: drop it from the pending
        buffer so :meth:`should_flush`/:meth:`pending` stop counting it.

        The on-disk frame is left in place until the next :meth:`mark_flushed`
        truncation — a crash-recovery replay of an already-applied record is
        harmless (updates are idempotent and ``fence_epoch``-guarded), and
        never rewriting the file here keeps the append path fsync-only.
        """
        with self._lock:
            self._pending.pop(path, None)
            if not self._pending:
                self._first_dirty_t = None

    def mark_flushed(self) -> None:
        """The buffered updates reached their origin DTNs; reset durably."""
        with self._lock:
            self._pending.clear()
            self._first_dirty_t = None
            if self._fh is not None and self._file_dirty:
                self._fh.truncate(0)
                self._fh.seek(0)
                self._fh.write(_JOURNAL_MAGIC)
                self._fh.flush()
                os.fsync(self._fh.fileno())
                self._file_dirty = False

    # -- crash recovery --------------------------------------------------------
    @staticmethod
    def _scan(path: str) -> Tuple[List[Dict[str, Any]], int]:
        """(intact records, byte offset where the intact prefix ends)."""
        out: List[Dict[str, Any]] = []
        if not os.path.exists(path):
            return out, 0
        with open(path, "rb") as fh:
            if fh.read(len(_JOURNAL_MAGIC)) != _JOURNAL_MAGIC:
                return out, 0  # unreadable header: treat the file as empty
            valid_end = len(_JOURNAL_MAGIC)
            while True:
                head = fh.read(4)
                if len(head) < 4:
                    break
                (n,) = struct.unpack("<I", head)
                payload = fh.read(n)
                if len(payload) < n:
                    break  # torn final record: crash mid-append, not acknowledged
                try:
                    out.append(unpack(payload))
                except (ValueError, struct.error):
                    break
                valid_end += 4 + n
        return out, valid_end

    @staticmethod
    def read_records(path: str) -> List[Dict[str, Any]]:
        """All intact records in an on-disk journal, append order."""
        return WriteBackJournal._scan(path)[0]

    def recover(self) -> Dict[str, Dict[str, Any]]:
        """Load journaled updates into the pending buffer (merged per path)."""
        if self.path is None:
            return {}
        records = self.read_records(self.path)
        with self._lock:
            for rec in records:
                self._pending.setdefault(rec["path"], {}).update(rec.get("kw") or {})
                epoch = int(rec.get("epoch") or 0)
                if epoch > self._fences.get(rec["path"], 0):
                    self._fences[rec["path"]] = epoch
            if records:
                self._file_dirty = True
                if self._first_dirty_t is None:
                    self._first_dirty_t = time.time()
        return self.pending()

    def recovered_fences(self) -> Dict[str, int]:
        """Per-path witnessed-epoch fences of the recovered records: a replay
        must not apply over a row newer than what the dead client had seen."""
        with self._lock:
            return dict(self._fences)

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


# ---------------------------------------------------------------------------
# Heal-time anti-entropy
# ---------------------------------------------------------------------------


class AntiEntropyReconciler:
    """Digest-exchange reconciliation after a partition heals.

    The pumps already replay everything both sides *logged* once the link is
    back (cursors are held, not reset), so the first phase is simply a
    quiesce.  What the pumps cannot see is state divergence with no pending
    log delta — records lost to a crashed log tail, or rows applied through
    the quorum push path on one side only.  For those, every live DTN
    exchanges **per-path watermark digests** (``MetadataService.path_digest``
    / ``DiscoveryService.index_digest``: just (epoch, origin) stamps, no
    rows), the global winner per path is chosen by (epoch, origin)
    last-writer-wins — fencing-token priority is inherent, because fence
    tokens and mutation epochs are minted from the same Lamport clocks, so a
    successor lease's writes always carry larger epochs than the fenced-out
    holder's — and only the diff is replayed, both ways, through the same
    idempotent ``apply_replicated`` surfaces the pumps use (with ``wm=0`` so
    a targeted replay never inflates a replica's applied watermark).

    :meth:`reconcile_report` summarizes what converged: paths checked/
    converged, conflicts resolved (paths where ≥2 distinct stamps were
    live), and records replayed per service.
    """

    def __init__(self, collab: "Collaboration", prefix: str = RECONCILE_PREFIX):
        self.collab = collab
        self.prefix = prefix
        self._report: Dict[str, Any] = {"ran": False}

    # -- helpers ---------------------------------------------------------------
    def _covers(self, tomb_path: str, path: str) -> bool:
        return path == tomb_path or path.startswith(tomb_path.rstrip("/") + "/")

    def _live_dtns(self) -> List["DTN"]:
        return [d for d in self.collab.dtns if not d.down]

    # -- the sweep -------------------------------------------------------------
    def run(self, timeout_s: float = RECONCILE_TIMEOUT_S) -> Dict[str, Any]:
        collab = self.collab
        report: Dict[str, Any] = {
            "ran": True,
            "prefix": self.prefix,
            "pump_quiesced": True,
            "paths_checked": 0,
            "paths_converged": 0,
            "conflicts_resolved": 0,
            "records_replayed": 0,
            "index_records_replayed": 0,
            "converged": False,
        }
        # phase 0: pump-driven bidirectional replay of everything logged
        if collab.replication_enabled:
            report["pump_quiesced"] = collab.quiesce_replication(timeout_s=timeout_s)
        live = self._live_dtns()
        if len(live) < 2:
            report["converged"] = True
            report["ran"] = bool(live)
            self._report = report
            return report

        # phase 1: metadata digest exchange + diff replay
        digests = {d.dtn_id: d.metadata.path_digest(self.prefix) for d in live}
        # global tombstone view: max stamp per tombstoned path
        tombs: Dict[str, Tuple[int, int]] = {}
        for dig in digests.values():
            for path, stamp in dig["tombs"].items():
                if tuple(stamp) > tombs.get(path, (0, 0)):
                    tombs[path] = (int(stamp[0]), int(stamp[1]))
        all_paths = sorted({p for dig in digests.values() for p in dig["rows"]})
        report["paths_checked"] = len(all_paths)
        for path, stamp in tombs.items():
            # spread the tombstone itself to DTNs that never saw the unlink
            record = {
                "service": "meta", "op": "unlink", "path": path,
                "epoch": stamp[0], "origin": stamp[1], "wm": 0,
            }
            for dtn in live:
                if tuple(digests[dtn.dtn_id]["tombs"].get(path, (0, 0))) != stamp:
                    dtn.metadata.apply_replicated([dict(record)])
                    report["records_replayed"] += 1
        for path in all_paths:
            stamps = {
                d.dtn_id: tuple(digests[d.dtn_id]["rows"].get(path, (0, 0)))
                for d in live
            }
            present = {s for s in stamps.values() if s != (0, 0)}
            winner = max(present)
            # a covering subtree tombstone newer than the winning row deletes
            # the path everywhere; the tombstone replay above already did that
            dead = any(
                self._covers(tp, path) and ts >= winner for tp, ts in tombs.items()
            )
            if len(present) > 1:
                report["conflicts_resolved"] += 1
            if dead:
                continue
            holder = next(d for d in live if stamps[d.dtn_id] == winner)
            entries = holder.metadata.export_entries([path])
            if not entries:
                continue
            record = {
                "service": "meta", "op": "upsert", "entries": entries,
                "epoch": winner[0], "origin": winner[1], "wm": 0,
            }
            for dtn in live:
                if stamps[dtn.dtn_id] != winner:
                    dtn.metadata.apply_replicated([dict(record)])
                    report["records_replayed"] += 1

        # phase 2: discovery-index digest exchange + replacement-set replay
        idx_digests = {d.dtn_id: d.discovery.index_digest(self.prefix) for d in live}
        pairs: Dict[Tuple[str, int], int] = {}
        for dig in idx_digests.values():
            for path, by_origin in dig.items():
                for origin, epoch in by_origin.items():
                    key = (path, int(origin))
                    if int(epoch) > pairs.get(key, 0):
                        pairs[key] = int(epoch)
        for (path, origin), epoch in sorted(pairs.items()):
            holder = next(
                d for d in live
                if idx_digests[d.dtn_id].get(path, {}).get(str(origin), 0) == epoch
            )
            rows = holder.discovery.export_index_rows(path, origin)
            record = {
                "service": "sds", "op": "index", "path": path, "rows": rows,
                "epoch": epoch, "origin": origin, "wm": 0,
            }
            for dtn in live:
                if dtn.dtn_id == origin:
                    continue  # a DTN's own-origin rows are authoritative
                if idx_digests[dtn.dtn_id].get(path, {}).get(str(origin), 0) != epoch:
                    dtn.discovery.apply_replicated_index([dict(record)])
                    report["index_records_replayed"] += 1

        # phase 3: verify — recompute digests, demand byte-level agreement
        final = [d.metadata.path_digest(self.prefix) for d in live]
        final_idx = [d.discovery.index_digest(self.prefix) for d in live]
        rows_agree = all(f["rows"] == final[0]["rows"] for f in final[1:])
        idx_agree = all(f == final_idx[0] for f in final_idx[1:])
        report["paths_converged"] = sum(
            1 for path in all_paths
            if len({tuple(f["rows"].get(path, (0, 0))) for f in final}) == 1
        )
        report["converged"] = rows_agree and idx_agree
        self._report = report
        return report

    def reconcile_report(self) -> Dict[str, Any]:
        """The last :meth:`run`'s summary (``{"ran": False}`` before any)."""
        return dict(self._report)
