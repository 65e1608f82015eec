"""Template namespaces (§III-B4).

A collaborator may participate in multiple, possibly overlapping
collaborations.  SCISPACE models each collaboration as a *template namespace*
with a pathname prefix and a scope:

- ``local``  — files under the prefix are visible only to their owner;
- ``global`` — files are visible to every collaborator in the workspace.

"When a file is written, its pathname determines the namespace, which in turn
defines the scope of the file content."  Resolution is longest-prefix-match
over the registered templates; paths that match no template fall into the
default global namespace (ns_id 0).

The namespace table is small and replicated onto every DTN's metadata shard
(Fig. 4 shows it alongside the file-mapping schema); this module is the
client-side registry + resolver shared by the workspace and MEU.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, Optional

__all__ = ["Namespace", "NamespaceRegistry", "DEFAULT_NS"]


@dataclass(frozen=True)
class Namespace:
    ns_id: int
    name: str
    scope: str  # 'local' | 'global'
    owner: str
    prefix: str

    def __post_init__(self):
        if self.scope not in ("local", "global"):
            raise ValueError(f"namespace scope must be local|global, got {self.scope!r}")
        if not self.prefix.startswith("/"):
            raise ValueError("namespace prefix must be absolute")

    def visible_to(self, collaborator: str) -> bool:
        return self.scope == "global" or self.owner == collaborator

    def to_message(self) -> Dict:
        return {
            "ns_id": self.ns_id,
            "name": self.name,
            "scope": self.scope,
            "owner": self.owner,
            "prefix": self.prefix,
        }


#: Paths outside any template fall into the shared default namespace.
DEFAULT_NS = Namespace(ns_id=0, name="default", scope="global", owner="", prefix="/")


class NamespaceRegistry:
    """Client-side registry; authoritative copies live in the DTN shards."""

    def __init__(self):
        self._lock = threading.Lock()
        self._by_id: Dict[int, Namespace] = {0: DEFAULT_NS}
        self._next_id = 1

    def define(self, name: str, scope: str, owner: str, prefix: str) -> Namespace:
        prefix = "/" + prefix.strip("/")
        with self._lock:
            for ns in self._by_id.values():
                if ns.name == name:
                    raise ValueError(f"namespace {name!r} already defined")
            ns = Namespace(self._next_id, name, scope, owner, prefix)
            self._by_id[ns.ns_id] = ns
            self._next_id += 1
            return ns

    def ingest(self, msg: Dict) -> Namespace:
        """Install a namespace learned from a DTN shard (replication path)."""
        ns = Namespace(msg["ns_id"], msg["name"], msg["scope"], msg["owner"], msg["prefix"])
        with self._lock:
            self._by_id[ns.ns_id] = ns
            self._next_id = max(self._next_id, ns.ns_id + 1)
            return ns

    def resolve(self, path: str) -> Namespace:
        """Longest-prefix-match of ``path`` against registered templates."""
        best = DEFAULT_NS
        with self._lock:
            for ns in self._by_id.values():
                pfx = ns.prefix.rstrip("/")
                if path == ns.prefix or path.startswith(pfx + "/") or ns.prefix == "/":
                    if len(ns.prefix) > len(best.prefix):
                        best = ns
        return best

    def get(self, ns_id: int) -> Optional[Namespace]:
        with self._lock:
            return self._by_id.get(ns_id)

    def all(self) -> List[Namespace]:
        with self._lock:
            return list(self._by_id.values())

    def visible_ids(self, collaborator: str) -> List[int]:
        with self._lock:
            return [ns.ns_id for ns in self._by_id.values() if ns.visible_to(collaborator)]
