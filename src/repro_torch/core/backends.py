"""Storage backends: each backend stands in for one data center's PFS (Lustre).

SCISPACE "merely adds a thin virtual abstraction layer on top of the
mountpoints" of data-center file systems (§III-B5) and inherits
fault-tolerance/replication from them.  The backends here play the role of
those mountpoints:

- :class:`PosixBackend` — a real directory tree (what a Lustre client mount
  looks like to scifs).
- :class:`MemoryBackend` — an in-memory tree for high-file-count benchmarks
  (the paper's 1M zero-size-file MEU experiment) and for tests.

Both support the extended attribute (xattr) interface the paper's export
protocol depends on: the ``sync`` flag is an xattr on files and directories
(§III-B1, §III-B3).  Xattrs are kept in an in-process table rather than
kernel xattrs so the code runs on any filesystem; ``flush_xattrs`` persists
them for restart tests.

Consistency note (faithful to the paper, with one fix): the paper clears the
``sync`` flag of the *parent* directory when an entry changes; for MEU's
subtree pruning to be sound the invalidation must propagate to *all*
ancestors, otherwise a synced grandparent would hide a dirty subtree.  We
propagate to the root and record the deviation in DESIGN.md.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

__all__ = [
    "StatResult",
    "StorageBackend",
    "PosixBackend",
    "MemoryBackend",
    "SYNC_XATTR",
    "OWNER_XATTR",
]

#: Name of the extended attribute holding the export flag (§III-B1).
SYNC_XATTR = "user.scispace.sync"
#: Extended attribute persisting a file's owner on backends whose host
#: filesystem has no collaborator identity (PosixBackend) — without it MEU
#: exports over a Posix root would lose ownership.
OWNER_XATTR = "user.scispace.owner"


@dataclass
class StatResult:
    path: str
    size: int
    is_dir: bool
    ctime: float
    mtime: float
    owner: str = ""

    def to_message(self) -> Dict:
        return {
            "path": self.path,
            "size": self.size,
            "is_dir": self.is_dir,
            "ctime": self.ctime,
            "mtime": self.mtime,
            "owner": self.owner,
        }


def _norm(path: str) -> str:
    path = "/" + path.strip("/")
    while "//" in path:
        path = path.replace("//", "/")
    return path


def _parents(path: str) -> Iterator[str]:
    """Yield every ancestor of ``path`` up to and including the root '/'."""
    path = _norm(path)
    while path != "/":
        path = path.rsplit("/", 1)[0] or "/"
        yield path


class StorageBackend:
    """Abstract data-center file system mountpoint."""

    def __init__(self, dc_id: str):
        self.dc_id = dc_id
        self._xattrs: Dict[str, Dict[str, str]] = {}
        self._xattr_lock = threading.Lock()

    # -- data plane ---------------------------------------------------------
    def write(self, path: str, data: bytes, *, offset: int = 0, owner: str = "") -> int:
        """Store ``data`` at ``offset``.  An ``offset=0`` write is a *full
        rewrite* (POSIX ``O_TRUNC`` semantics): any previous tail beyond
        ``len(data)`` is truncated, never left behind."""
        raise NotImplementedError

    def read(self, path: str, *, offset: int = 0, length: int = -1) -> bytes:
        raise NotImplementedError

    # -- deferred variants (data-plane pipelining) ---------------------------
    # The simulated PFS delay (store_delay_for) is normally slept inside
    # read/write.  The striped data path overlaps store fetches with wire
    # time, so it needs the payload *now* and the modeled delay *returned*
    # instead of slept — mirroring RpcClient.call_deferred.  Backends with
    # real I/O (PosixBackend) pay real time and return 0.
    def store_delay_for(self, nbytes: int) -> float:
        """Modeled PFS delay for an ``nbytes`` transfer (0 for real I/O)."""
        return 0.0

    def read_deferred(self, path: str, *, offset: int = 0, length: int = -1) -> "Tuple[bytes, float]":
        data = self.read(path, offset=offset, length=length)
        return data, 0.0

    def write_deferred(
        self, path: str, data: bytes, *, offset: int = 0, owner: str = ""
    ) -> "Tuple[int, float]":
        return self.write(path, data, offset=offset, owner=owner), 0.0

    def create(self, path: str, *, owner: str = "") -> None:
        """Create an empty file (the paper's zero-size-file MEU workload)."""
        self.write(path, b"", owner=owner)

    def mkdir(self, path: str, *, owner: str = "", exist_ok: bool = True) -> None:
        raise NotImplementedError

    def delete(self, path: str) -> None:
        raise NotImplementedError

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def stat(self, path: str) -> StatResult:
        raise NotImplementedError

    def listdir(self, path: str) -> List[str]:
        raise NotImplementedError

    def walk(self, root: str = "/") -> Iterator[StatResult]:
        """Depth-first walk over all entries under ``root``."""
        stack = [_norm(root)]
        while stack:
            cur = stack.pop()
            for name in sorted(self.listdir(cur), reverse=True):
                child = _norm(cur + "/" + name)
                st = self.stat(child)
                yield st
                if st.is_dir:
                    stack.append(child)

    # -- xattrs (export-protocol flags) --------------------------------------
    def set_xattr(self, path: str, name: str, value: str) -> None:
        with self._xattr_lock:
            self._xattrs.setdefault(_norm(path), {})[name] = value

    def get_xattr(self, path: str, name: str) -> Optional[str]:
        with self._xattr_lock:
            return self._xattrs.get(_norm(path), {}).get(name)

    def remove_xattr(self, path: str, name: str) -> None:
        with self._xattr_lock:
            self._xattrs.get(_norm(path), {}).pop(name, None)

    def drop_xattrs_under(self, path: str) -> None:
        """Forget all xattrs on ``path`` and its subtree (after a delete), so
        a later re-creation cannot inherit a stale owner or sync flag."""
        path = _norm(path)
        prefix = path + "/"
        with self._xattr_lock:
            for p in [p for p in self._xattrs if p == path or p.startswith(prefix)]:
                del self._xattrs[p]

    def invalidate_sync_up(self, path: str) -> None:
        """Clear the sync flag on all ancestors of ``path`` (export protocol).

        The paper clears only the immediate parent (§III-B3); we propagate to
        the root so MEU's subtree pruning can never skip a dirty subtree.
        """
        with self._xattr_lock:
            for parent in _parents(path):
                attrs = self._xattrs.get(parent)
                if attrs is not None:
                    attrs.pop(SYNC_XATTR, None)

    def flush_xattrs(self, path: str) -> None:
        """Persist the xattr table (PosixBackend only; no-op otherwise)."""

    # -- bookkeeping ----------------------------------------------------------
    def data_bytes_written(self) -> int:
        raise NotImplementedError


class MemoryBackend(StorageBackend):
    """In-memory tree; used for metadata-rate experiments and tests.

    ``store_gbps`` (0 ⇒ free) models the PFS data-plane bandwidth so that
    benchmark ratios between metadata-bound and data-bound paths resemble a
    real Lustre deployment rather than RAM speed (DESIGN.md §8).
    """

    def __init__(self, dc_id: str, *, store_gbps: float = 0.0, store_lat_s: float = 0.0):
        super().__init__(dc_id)
        self._lock = threading.Lock()
        self.store_gbps = store_gbps
        self.store_lat_s = store_lat_s
        # path -> bytes for files; path -> None marks a directory
        self._files: Dict[str, Optional[bytearray]] = {"/": None}
        self._meta: Dict[str, Dict] = {"/": {"ctime": time.time(), "mtime": time.time(), "owner": ""}}
        self._bytes_written = 0

    def store_delay_for(self, nbytes: int) -> float:
        delay = self.store_lat_s if nbytes > 0 else 0.0
        if self.store_gbps > 0 and nbytes > 0:
            delay += nbytes * 8 / (self.store_gbps * 1e9)
        return delay

    def _store_delay(self, nbytes: int) -> None:
        delay = self.store_delay_for(nbytes)
        if delay > 0:
            time.sleep(delay)

    def _require_parent(self, path: str) -> None:
        parent = path.rsplit("/", 1)[0] or "/"
        if parent not in self._files:
            # implicit mkdir -p (Lustre clients do this via the app; keep tests terse)
            self._mkdir_locked(parent)

    def _mkdir_locked(self, path: str) -> None:
        path = _norm(path)
        if path in self._files:
            return
        parent = path.rsplit("/", 1)[0] or "/"
        if parent not in self._files:
            self._mkdir_locked(parent)
        now = time.time()
        self._files[path] = None
        self._meta[path] = {"ctime": now, "mtime": now, "owner": ""}

    def write(self, path: str, data: bytes, *, offset: int = 0, owner: str = "") -> int:
        n, delay = self.write_deferred(path, data, offset=offset, owner=owner)
        if delay > 0:
            time.sleep(delay)
        return n

    def write_deferred(
        self, path: str, data: bytes, *, offset: int = 0, owner: str = ""
    ) -> Tuple[int, float]:
        path = _norm(path)
        with self._lock:
            self._require_parent(path)
            buf = self._files.get(path)
            now = time.time()
            if buf is None or not isinstance(buf, bytearray):
                buf = bytearray()
                self._files[path] = buf
                self._meta[path] = {"ctime": now, "mtime": now, "owner": owner}
            if offset > len(buf):
                buf.extend(b"\x00" * (offset - len(buf)))
            buf[offset : offset + len(data)] = data
            if offset == 0:
                # full rewrite: drop any stale tail (O_TRUNC semantics)
                del buf[len(data):]
            self._meta[path]["mtime"] = now
            self._bytes_written += len(data)
        self.invalidate_sync_up(path)
        return len(data), self.store_delay_for(len(data))

    def read(self, path: str, *, offset: int = 0, length: int = -1) -> bytes:
        out, delay = self.read_deferred(path, offset=offset, length=length)
        if delay > 0:
            time.sleep(delay)
        return out

    def read_deferred(self, path: str, *, offset: int = 0, length: int = -1) -> Tuple[bytes, float]:
        path = _norm(path)
        with self._lock:
            buf = self._files.get(path)
            if buf is None or not isinstance(buf, bytearray):
                raise FileNotFoundError(path)
            out = bytes(buf[offset:]) if length < 0 else bytes(buf[offset : offset + length])
        return out, self.store_delay_for(len(out))

    def mkdir(self, path: str, *, owner: str = "", exist_ok: bool = True) -> None:
        path = _norm(path)
        with self._lock:
            if path in self._files:
                if self._files[path] is not None:
                    raise FileExistsError(f"{path} is a file")
                if not exist_ok:
                    raise FileExistsError(path)
                return
            self._mkdir_locked(path)
            self._meta[path]["owner"] = owner
        self.invalidate_sync_up(path)

    def delete(self, path: str) -> None:
        path = _norm(path)
        with self._lock:
            if path not in self._files:
                raise FileNotFoundError(path)
            doomed = [p for p in self._files if p == path or p.startswith(path + "/")]
            for p in doomed:
                self._files.pop(p, None)
                self._meta.pop(p, None)
        self.drop_xattrs_under(path)
        self.invalidate_sync_up(path)

    def exists(self, path: str) -> bool:
        with self._lock:
            return _norm(path) in self._files

    def stat(self, path: str) -> StatResult:
        path = _norm(path)
        with self._lock:
            if path not in self._files:
                raise FileNotFoundError(path)
            buf = self._files[path]
            meta = self._meta[path]
            return StatResult(
                path=path,
                size=0 if buf is None else len(buf),
                is_dir=buf is None,
                ctime=meta["ctime"],
                mtime=meta["mtime"],
                owner=meta.get("owner", ""),
            )

    def listdir(self, path: str) -> List[str]:
        path = _norm(path)
        with self._lock:
            if path not in self._files or self._files[path] is not None:
                raise NotADirectoryError(path)
            prefix = "/" if path == "/" else path + "/"
            out = []
            for p in self._files:
                if p != "/" and p.startswith(prefix):
                    rest = p[len(prefix) :]
                    if "/" not in rest:
                        out.append(rest)
            return out

    def data_bytes_written(self) -> int:
        with self._lock:
            return self._bytes_written


class PosixBackend(StorageBackend):
    """A real directory tree rooted at ``root`` (a 'Lustre client mount')."""

    XATTR_DB = ".scispace_xattrs.json"

    def __init__(self, dc_id: str, root: str):
        super().__init__(dc_id)
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        self._bytes_written = 0
        self._count_lock = threading.Lock()
        db = os.path.join(self.root, self.XATTR_DB)
        if os.path.exists(db):
            with open(db, "r", encoding="utf-8") as fh:
                self._xattrs = json.load(fh)

    def _host(self, path: str) -> str:
        rel = _norm(path).lstrip("/")
        return os.path.join(self.root, rel) if rel else self.root

    def write(self, path: str, data: bytes, *, offset: int = 0, owner: str = "") -> int:
        path = _norm(path)
        host = self._host(path)
        os.makedirs(os.path.dirname(host), exist_ok=True)
        mode = "r+b" if os.path.exists(host) else "wb"
        with open(host, mode) as fh:
            fh.seek(offset)
            fh.write(data)
            if offset == 0:
                # full rewrite: an existing longer file must not keep its old
                # tail past the new data (O_TRUNC semantics)
                fh.truncate()
        if owner and self.get_xattr(path, OWNER_XATTR) is None:
            # first writer owns the file (mirrors MemoryBackend, which pins
            # owner at creation); persisted via the xattr table so MEU
            # exports over a Posix root keep ownership
            self.set_xattr(path, OWNER_XATTR, owner)
        with self._count_lock:
            self._bytes_written += len(data)
        self.invalidate_sync_up(path)
        return len(data)

    def read(self, path: str, *, offset: int = 0, length: int = -1) -> bytes:
        host = self._host(path)
        if not os.path.isfile(host):
            raise FileNotFoundError(path)
        with open(host, "rb") as fh:
            fh.seek(offset)
            return fh.read() if length < 0 else fh.read(length)

    def mkdir(self, path: str, *, owner: str = "", exist_ok: bool = True) -> None:
        os.makedirs(self._host(path), exist_ok=exist_ok)
        if owner and self.get_xattr(path, OWNER_XATTR) is None:
            self.set_xattr(path, OWNER_XATTR, owner)
        self.invalidate_sync_up(path)

    def delete(self, path: str) -> None:
        host = self._host(path)
        if os.path.isdir(host):
            shutil.rmtree(host)
        elif os.path.exists(host):
            os.remove(host)
        else:
            raise FileNotFoundError(path)
        self.drop_xattrs_under(path)
        self.invalidate_sync_up(path)

    def exists(self, path: str) -> bool:
        return os.path.exists(self._host(path))

    def stat(self, path: str) -> StatResult:
        host = self._host(path)
        if not os.path.exists(host):
            raise FileNotFoundError(path)
        st = os.stat(host)
        return StatResult(
            path=_norm(path),
            size=0 if os.path.isdir(host) else st.st_size,
            is_dir=os.path.isdir(host),
            ctime=st.st_ctime,
            mtime=st.st_mtime,
            owner=self.get_xattr(path, OWNER_XATTR) or "",
        )

    def listdir(self, path: str) -> List[str]:
        host = self._host(path)
        if not os.path.isdir(host):
            raise NotADirectoryError(path)
        return [n for n in os.listdir(host) if n != self.XATTR_DB]

    def flush_xattrs(self, path: str = "/") -> None:
        with self._xattr_lock:
            snapshot = json.dumps(self._xattrs)
        with open(os.path.join(self.root, self.XATTR_DB), "w", encoding="utf-8") as fh:
            fh.write(snapshot)

    def data_bytes_written(self) -> int:
        with self._count_lock:
            return self._bytes_written
