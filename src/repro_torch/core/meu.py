"""Metadata Export Utility — MEU (§III-B3, Fig. 5).

Commits the metadata of natively-written (local-write) datasets into the
collaboration-workspace namespace.  "This concept works in a similar fashion
to git local and remote repository management."

Protocol, faithful to the paper:

1. **Scan** — recursively walk a local directory.  Before descending into a
   directory, check its ``sync`` extended attribute: if set, the entire
   subtree is already exported and is skipped (the pruning optimization of
   Fig. 5).  Collect every unsynchronized file/directory.
2. **Mark** — after the scan, set the ``sync`` xattr on all collected
   entries (and on fully-scanned directories so future scans prune).
3. **Commit** — pack *all* unsynchronized metadata into a single batched
   message per owning DTN ("packs all unsynchronized metadata into a single
   message to minimize the synchronization overhead") and send one
   ``batch_upsert`` RPC each.

Fine-grained sharing: ``export(root=...)`` restricts the commit to a subtree,
and ``exclude`` drops entries, so a collaborator can publish only a subset of
a dataset (§III-B3).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from .backends import StorageBackend, SYNC_XATTR
from .cluster import Collaboration, DataCenter
from .metadata import hash_placement
from .plane import ServicePlane

__all__ = ["MEU", "ExportReport"]


@dataclass
class ExportReport:
    scanned_dirs: int = 0
    pruned_dirs: int = 0
    exported_files: int = 0
    exported_dirs: int = 0
    rpc_calls: int = 0
    bytes_sent: int = 0
    scan_seconds: float = 0.0
    commit_seconds: float = 0.0
    #: "sync-fanout" = one batch per owning DTN collaboration-wide (paper's
    #: protocol); "async-log" = origin-commit on the home DC only, shipped
    #: to peers by the replication tier
    mode: str = "sync-fanout"

    def total_exported(self) -> int:
        return self.exported_files + self.exported_dirs


class MEU:
    """One collaborator's export utility for one data center namespace."""

    def __init__(self, collab: Collaboration, dc: DataCenter, collaborator: str):
        self.collab = collab
        self.dc = dc
        self.backend: StorageBackend = dc.backend
        self.collaborator = collaborator
        # all service interaction rides the metadata plane: pooled per-DTN
        # clients + concurrent bounded fan-out for the per-DTN commit batches.
        # The MEU only writes, so its plane publishes invalidations without
        # subscribing a cache of its own.
        self.plane = ServicePlane(collab, dc.dc_id, subscribe=False)

    # -- scan phase ---------------------------------------------------------------
    def scan(self, root: str = "/", report: Optional[ExportReport] = None) -> List[Dict]:
        """Collect unsynchronized entries under ``root`` with subtree pruning."""
        report = report if report is not None else ExportReport()
        out: List[Dict] = []
        stack = [root.rstrip("/") or "/"]
        while stack:
            cur = stack.pop()
            report.scanned_dirs += 1
            for name in self.backend.listdir(cur):
                child = (cur.rstrip("/") + "/" + name) if cur != "/" else "/" + name
                st = self.backend.stat(child)
                synced = self.backend.get_xattr(child, SYNC_XATTR) == "true"
                if st.is_dir:
                    if synced:
                        # Fig. 5: flag true ⇒ whole subtree already exported
                        report.pruned_dirs += 1
                        continue
                    out.append(
                        {
                            "path": child,
                            "is_dir": 1,
                            "size": 0,
                            "ctime": st.ctime,
                            "mtime": st.mtime,
                            "owner": st.owner or self.collaborator,
                        }
                    )
                    stack.append(child)
                else:
                    if synced:
                        continue
                    out.append(
                        {
                            "path": child,
                            "is_dir": 0,
                            "size": st.size,
                            "ctime": st.ctime,
                            "mtime": st.mtime,
                            "owner": st.owner or self.collaborator,
                        }
                    )
        return out

    # -- full export ----------------------------------------------------------------
    def export(
        self,
        root: str = "/",
        *,
        exclude: Optional[Callable[[str], bool]] = None,
        mark_synced: bool = True,
        via_replication: Optional[bool] = None,
    ) -> ExportReport:
        """Scan + mark + batched commit.

        With the collaboration's replication tier running (or
        ``via_replication=True``) the commit is the paper's asynchronous
        export made literal: entries are committed **once**, as origin rows
        on this data center's own DTNs (local hash placement, like
        LW-offline extraction), appended to their replication logs, and the
        ReplicaPump ships them to every other DTN in the background — the
        WAN sees the batches off the commit path, within the pump's
        count/age lag bound.  Otherwise the commit fans out synchronously,
        one batch per owning DTN collaboration-wide (global hash).
        """
        report = ExportReport()
        t0 = time.perf_counter()
        entries = self.scan(root, report)
        if exclude is not None:
            entries = [e for e in entries if not exclude(e["path"])]
        report.scan_seconds = time.perf_counter() - t0

        use_log = (
            via_replication
            if via_replication is not None
            else self.collab.replication_enabled
        )
        t1 = time.perf_counter()
        # one batch RPC per target DTN; the plane fans the commits out
        # concurrently (bounded).  async-log targets only the home DC.
        if use_log:
            report.mode = "async-log"
            local_ids = [d.dtn_id for d in self.dc.dtns]
            placement = lambda path: local_ids[hash_placement(path, len(local_ids))]
        else:
            n = len(self.collab.dtns)
            placement = lambda path: hash_placement(path, n)
        batches: Dict[int, List[Dict]] = {}
        for e in entries:
            e2 = dict(e)
            e2["dc_id"] = self.dc.dc_id
            e2["ns_id"] = self.collab.namespaces.resolve(e["path"]).ns_id
            e2["sync"] = 1
            batches.setdefault(placement(e["path"]), []).append(e2)
        before = {i: self.plane.meta[i].stats.bytes_sent for i in batches}
        self.plane.scatter(
            "meta",
            "batch_upsert",
            per_dtn_kwargs={i: {"entries": batch} for i, batch in batches.items()},
        )
        for dtn_idx in batches:
            report.rpc_calls += 1
            report.bytes_sent += self.plane.meta[dtn_idx].stats.bytes_sent - before[dtn_idx]
        # exported rows supersede anything other clients may have cached
        self.plane.publish([e["path"] for e in entries])
        report.commit_seconds = time.perf_counter() - t1

        if mark_synced:
            for e in entries:
                self.backend.set_xattr(e["path"], SYNC_XATTR, "true")
            # a fully-exported root prunes future scans entirely
            if exclude is None:
                self.backend.set_xattr(root.rstrip("/") or "/", SYNC_XATTR, "true")

        report.exported_files = sum(1 for e in entries if not e["is_dir"])
        report.exported_dirs = sum(1 for e in entries if e["is_dir"])
        return report

    def close(self) -> None:
        self.plane.close()
