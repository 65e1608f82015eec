"""Epoch-fenced write leases for the partition-tolerant write path.

The problem: the fault plane made *reads* survive
an origin partition by failing over to home-DC replicas, but every mutating
op still failed fast.  Accepting writes away from a path's owner is only
safe if (a) at most one writer coordinates a prefix at a time, and (b) a
writer that *lost* that right — its lease expired during a partition and a
successor took over — can never slip a late mutation into the replicated
state.  Both are solved the classic way (Chubby/GFS-style leases + fencing
tokens), built on the machinery this repo already has:

- **Leases** are per-path-prefix write grants with a TTL, granted by a
  majority of the prefix's replica set (``Collaboration.replica_set`` —
  the owner DTN by path hash plus its ring successors).  Each granting DTN
  keeps a :class:`LeaseTable`; the client-side :class:`LeaseManager`
  collects grants and holds the lease.
- **Fencing tokens** are minted from the granting DTN's Lamport
  :class:`~repro_torch.core.replication.EpochClock` (``max(clock.tick(),
  floor + 1)``), so tokens are totally ordered *and* comparable with
  mutation epochs — the "fencing-token priority" the heal-time reconciler
  leans on falls out of sharing one clock domain.  The lease's token is the
  max over its grants.
- **Admission** (:meth:`LeaseTable.admit`) is check-and-observe: a mutating
  RPC carrying ``{"prefix", "token"}`` is dispatched only if ``token >=``
  the prefix's *fence floor* (the highest token this DTN has granted or
  witnessed); admitting raises the floor to the token.  Floors therefore
  propagate with the writes themselves: once any successor's token is seen,
  every older holder is fenced out at that DTN — the stale write is refused
  before it can reach the service or the replication log
  (:class:`~repro_torch.core.rpc.RpcFenced`).

Partition behavior (the reason this exists): when a full majority of the
replica set is unreachable, :meth:`LeaseManager.acquire` falls back to a
**sloppy quorum** — a majority of the *reachable* members — and marks the
lease ``degraded``.  Two partition sides can then hold degraded leases for
the same prefix simultaneously; that is deliberate (CAP: these are exactly
the writes we chose to accept), and safe because every degraded write is
stamped (epoch, origin) and the heal-time anti-entropy reconciler
(:class:`~repro_torch.core.replication.AntiEntropyReconciler`) converges all
sides by last-writer-wins.  Within one side, fencing stays airtight: grants
overlap on the reachable members, so floors strictly rise.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from .rpc import RpcError, RpcFenced, RpcUnavailable

__all__ = [
    "DEFAULT_LEASE_TTL_S",
    "Lease",
    "LeaseTable",
    "LeaseManager",
    "LeaseError",
    "LeaseUnavailable",
    "LeaseHeldElsewhere",
]

#: default write-lease TTL; configs/scispace_testbed.py re-exports this
DEFAULT_LEASE_TTL_S = 5.0

#: renew when less than this fraction of the TTL remains
_RENEW_MARGIN = 0.25


class LeaseError(RpcError):
    """A write lease could not be acquired or held."""


class LeaseUnavailable(LeaseError, RpcUnavailable):
    """Not even a majority of the *reachable* replica set granted — there is
    no safe coordinator for this prefix right now.  Retryable (the members
    may come back), hence also :class:`RpcUnavailable`."""


class LeaseHeldElsewhere(LeaseError):
    """Another holder owns a live lease on the prefix.  Not retryable until
    that lease expires or is released."""


@dataclass
class Lease:
    """A held write lease: the client-side token + bookkeeping."""

    prefix: str
    holder: str
    #: fencing token — max over the granting DTNs' minted tokens; carried as
    #: ``{"prefix", "token"}`` on every mutating RPC issued under this lease
    token: int
    expires_at: float
    #: granted by a sloppy (majority-of-reachable) quorum during a partition
    degraded: bool = False
    #: dtn indices that granted (the set renewals go back to)
    grants: List[int] = field(default_factory=list)

    def live(self, now: Optional[float] = None) -> bool:
        return (time.monotonic() if now is None else now) < self.expires_at

    def fence(self) -> Dict[str, Any]:
        return {"prefix": self.prefix, "token": self.token}


class LeaseTable:
    """Server-side lease state on one DTN: grants, TTLs, and fence floors.

    One table per DTN, shared by its metadata and discovery
    :class:`~repro_torch.core.rpc.RpcServer`\\ s (``fences=``) so a single floor
    governs both services' mutating envelopes.  All methods return plain
    dicts/bools — they are exposed over RPC via ``MetadataService``
    delegation (``lease_grant`` / ``lease_renew`` / ``lease_release``).
    """

    def __init__(self, clock: Any):
        self.clock = clock
        #: prefix -> (holder, token, expires_at monotonic)
        self._leases: Dict[str, Tuple[str, int, float]] = {}
        #: prefix -> highest token granted here or witnessed on a mutation
        self._floor: Dict[str, int] = {}
        self._lock = threading.Lock()
        self.granted = 0
        self.refused = 0
        self.fenced = 0

    def grant(self, prefix: str, holder: str, ttl_s: float) -> Dict[str, Any]:
        """Grant (or same-holder refresh) a lease; refuse if held by another.

        A grant mints a fresh token strictly above this DTN's fence floor —
        re-granting to the same holder therefore *advances* its token, which
        is harmless (the holder uses the new max) and keeps minting monotone.
        """
        now = time.monotonic()
        with self._lock:
            cur = self._leases.get(prefix)
            if cur is not None and cur[2] > now and cur[0] != holder:
                self.refused += 1
                return {
                    "granted": False,
                    "holder": cur[0],
                    "expires_in": cur[2] - now,
                    "floor": self._floor.get(prefix, 0),
                }
            token = max(self.clock.tick(), self._floor.get(prefix, 0) + 1)
            self._leases[prefix] = (holder, token, now + ttl_s)
            self._floor[prefix] = token
            self.granted += 1
            return {"granted": True, "token": token, "floor": token}

    def renew(self, prefix: str, holder: str, token: int, ttl_s: float) -> bool:
        """Extend a held lease without re-minting; False if lost/superseded."""
        now = time.monotonic()
        with self._lock:
            cur = self._leases.get(prefix)
            if cur is None or cur[0] != holder or cur[1] > int(token):
                return False
            self._leases[prefix] = (holder, cur[1], now + ttl_s)
            return True

    def release(self, prefix: str, holder: str, token: int) -> bool:
        """Drop the lease early.  The fence floor survives — releasing must
        never re-admit an even older token."""
        with self._lock:
            cur = self._leases.get(prefix)
            if cur is not None and cur[0] == holder and cur[1] <= int(token):
                del self._leases[prefix]
                return True
            return False

    def admit(self, prefix: str, token: int) -> bool:
        """Check-and-observe a mutation's fencing token against the floor."""
        token = int(token)
        with self._lock:
            floor = self._floor.get(prefix, 0)
            if token < floor:
                self.fenced += 1
                return False
            self._floor[prefix] = token
            return True

    def floor(self, prefix: str) -> int:
        with self._lock:
            return self._floor.get(prefix, 0)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "granted": self.granted,
                "refused": self.refused,
                "fenced": self.fenced,
                "live": sum(1 for _, _, exp in self._leases.values()
                            if exp > time.monotonic()),
            }


class LeaseManager:
    """Client-side acquisition and caching of per-prefix write leases.

    ``call`` is how grant RPCs reach a replica-set member:
    ``call(dtn_idx, method, **kw)`` — the service plane passes its breaker-
    guarded client call so lease traffic rides the same retry/fault path as
    everything else.  ``replica_set`` maps a prefix to the member indices
    (``Collaboration.replica_set``).
    """

    def __init__(
        self,
        holder: str,
        replica_set: Callable[[str], List[int]],
        call: Callable[..., Any],
        *,
        ttl_s: float = DEFAULT_LEASE_TTL_S,
        stand_ins: Optional[Callable[[str], List[int]]] = None,
        tracer: Optional[Any] = None,
    ):
        self.holder = holder
        self.ttl_s = ttl_s
        #: plane Tracer (optional): each acquisition records a
        #: ``lease.acquire`` span whose children are the grant-fan-out RPCs
        self._tracer = tracer
        self._replica_set = replica_set
        #: hinted-handoff extension of the preference list (Dynamo-style):
        #: when replica-set members are unreachable, further ring successors
        #: stand in as granting members so a minority side can still
        #: coordinate — their floors rise with the grant, keeping fencing
        #: airtight on the reachable side
        self._stand_ins = stand_ins
        self._call = call
        self._held: Dict[str, Lease] = {}
        self._lock = threading.Lock()
        self.acquired = 0
        self.degraded_acquired = 0
        self.renewed = 0

    def hold(self, prefix: str) -> Lease:
        """Return a live lease on ``prefix``, acquiring or renewing as needed."""
        now = time.monotonic()
        with self._lock:
            lease = self._held.get(prefix)
        if lease is not None and lease.expires_at - now > _RENEW_MARGIN * self.ttl_s:
            return lease
        if lease is not None and lease.live(now) and self._renew(lease):
            return lease
        return self.acquire(prefix)

    def acquire(self, prefix: str) -> Lease:
        """Collect grants from the prefix's replica set.

        Full majority of the set -> a normal lease.  Majority of only the
        *reachable* members (partition) -> a ``degraded`` lease (sloppy
        quorum; see module docstring for why that is safe here).  A live
        conflicting holder -> :class:`LeaseHeldElsewhere`; nothing reachable
        or grants below even the sloppy bar -> :class:`LeaseUnavailable`.

        With a tracer, the fan-out runs under a ``lease.acquire`` span
        (status ``degraded`` when the grant set needed stand-ins).
        """
        if self._tracer is None:
            return self._acquire(prefix)
        with self._tracer.span("lease.acquire", prefix=prefix) as sp:
            lease = self._acquire(prefix)
            if sp is not None:
                sp.tags.update(grants=len(lease.grants), token=lease.token)
                if lease.degraded:
                    sp.status = "degraded"
            return lease

    def _acquire(self, prefix: str) -> Lease:
        members = self._replica_set(prefix)
        need = len(members) // 2 + 1
        grants: List[int] = []
        tokens: List[int] = []
        conflict: Optional[Dict[str, Any]] = None
        reachable = 0
        for idx in members:
            try:
                res = self._call(
                    idx, "lease_grant",
                    prefix=prefix, holder=self.holder, ttl_s=self.ttl_s,
                )
            except RpcFenced:
                raise
            except RpcError:
                continue
            reachable += 1
            if res and res.get("granted"):
                grants.append(idx)
                tokens.append(int(res["token"]))
            elif res:
                conflict = res
        member_grants = len(grants)
        if member_grants < need and self._stand_ins is not None:
            # sloppy quorum: unreachable members are stood in for by the next
            # ring successors, topping the grant set back up to a majority
            for idx in self._stand_ins(prefix):
                if len(grants) >= need:
                    break
                try:
                    res = self._call(
                        idx, "lease_grant",
                        prefix=prefix, holder=self.holder, ttl_s=self.ttl_s,
                    )
                except RpcFenced:
                    raise
                except RpcError:
                    continue
                if res and res.get("granted"):
                    grants.append(idx)
                    tokens.append(int(res["token"]))
                elif res:
                    conflict = res
        if conflict is not None and len(grants) < need:
            raise LeaseHeldElsewhere(
                f"lease on {prefix!r} held by {conflict.get('holder')!r} "
                f"for another {conflict.get('expires_in', 0.0):.3f}s"
            )
        sloppy_need = reachable // 2 + 1
        if not grants or len(grants) < min(need, sloppy_need):
            raise LeaseUnavailable(
                f"lease on {prefix!r}: {len(grants)}/{len(members)} grants "
                f"({reachable} members reachable; majority needed)"
            )
        lease = Lease(
            prefix=prefix,
            holder=self.holder,
            token=max(tokens),
            expires_at=time.monotonic() + self.ttl_s,
            degraded=member_grants < need,
            grants=grants,
        )
        self.acquired += 1
        if lease.degraded:
            self.degraded_acquired += 1
        with self._lock:
            self._held[prefix] = lease
        return lease

    def _renew(self, lease: Lease) -> bool:
        """Extend on the grant set; majority of grants must still agree."""
        ok = 0
        for idx in lease.grants:
            try:
                if self._call(
                    idx, "lease_renew",
                    prefix=lease.prefix, holder=lease.holder,
                    token=lease.token, ttl_s=self.ttl_s,
                ):
                    ok += 1
            except RpcError:
                continue
        if ok < len(lease.grants) // 2 + 1:
            return False
        lease.expires_at = time.monotonic() + self.ttl_s
        self.renewed += 1
        return True

    def release(self, prefix: str) -> None:
        with self._lock:
            lease = self._held.pop(prefix, None)
        if lease is None:
            return
        for idx in lease.grants:
            try:
                self._call(
                    idx, "lease_release",
                    prefix=prefix, holder=lease.holder, token=lease.token,
                )
            except RpcError:
                continue

    def release_all(self) -> None:
        with self._lock:
            prefixes = list(self._held)
        for prefix in prefixes:
            self.release(prefix)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            held = len(self._held)
        return {
            "acquired": self.acquired,
            "degraded_acquired": self.degraded_acquired,
            "renewed": self.renewed,
            "held": held,
        }
