"""Deterministic fault injection for the SCISPACE collaboration.

The paper assumes DTNs and the terabit WAN links between data centers stay
up; a real geo-distributed workspace cannot.  This module is the *fault
plane*: a seedable :class:`FaultPlan` that injects failures at the
``Channel``/``RpcServer`` boundary where every service interaction already
flows, so the same workload can be replayed under drops, delays, duplicate
deliveries, DTN crashes, torn journal writes and link-level partitions —
and is expected to finish byte-identical to the fault-free run.

Injection points
----------------
* **Per-link message faults** — ``RpcClient._transmit`` asks
  :meth:`FaultPlan.on_message` before every transmission.  Rules are keyed
  on the directed ``(client dc, server dc)`` pair (``"*"`` wildcards) and can
  drop the request, drop the reply (the request *executed* — the case
  idempotency tokens exist for), duplicate the delivery, or add delay.
  Deterministic rules (``every=N``) count per-link messages; probabilistic
  rules draw from the plan's seeded RNG, so a given seed replays the same
  fault sequence for a single-threaded workload.
* **Partitions** — :meth:`partition` blocks a DC pair while both sides stay
  up (what ``DTN.crash()`` cannot express); :meth:`heal` lifts it.  The data
  plane consults :meth:`link_blocked` before bulk transfers.
* **Crash-at-Nth-call** — :meth:`crash_dtn_at_call` crashes a DTN the moment
  its servers have *served* N requests, optionally restarting it after a
  fixed outage, so "the DTN died mid-workload" lands at a reproducible point
  in the op stream rather than at a wall-clock instant.
* **Torn journal writes** — :meth:`torn_journal_append` makes the Nth
  :class:`~repro_torch.core.replication.WriteBackJournal` append write only a
  prefix of its record before failing (a torn fsync), driving the journal's
  torn-tail recovery path from an *injected* fault.

Install a plan with ``collab.install_faults(plan)`` — clients reach it
through a provider callable, so plans installed mid-run take effect
immediately and ``install_faults(None)`` turns injection off.
"""

from __future__ import annotations

import threading
import random
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["Fault", "LinkRule", "FaultPlan", "TornWrite", "canned_plan", "CANNED_PLANS"]


class TornWrite(OSError):
    """An injected torn write: only a prefix of the record reached the disk
    before the fault (power cut mid-fsync).  Raised out of the journal append
    so the writer sees the I/O failure a real torn write would produce."""


@dataclass
class Fault:
    """The decision for one message: what the fault plane does to it."""

    blocked: bool = False
    drop_request: bool = False
    drop_reply: bool = False
    duplicate: bool = False
    delay_s: float = 0.0


@dataclass
class LinkRule:
    """One fault rule on a directed DC link (``"*"`` matches any site).

    ``every=N`` fires deterministically on every Nth matching message;
    ``p`` fires probabilistically from the plan's seeded RNG.  ``limit``
    bounds total firings (-1 = unbounded).  ``kind`` is one of
    ``"drop"`` (request lost), ``"drop_reply"`` (request executed, reply
    lost), ``"dup"`` (delivered twice), ``"delay"`` (extra one-way latency).
    """

    kind: str
    src: str = "*"
    dst: str = "*"
    p: float = 0.0
    every: int = 0
    delay_s: float = 0.0
    limit: int = -1
    matched: int = field(default=0, repr=False)
    fired: int = field(default=0, repr=False)

    def matches(self, src: str, dst: str) -> bool:
        return (self.src == "*" or self.src == src) and (self.dst == "*" or self.dst == dst)

    def decide(self, rng: random.Random) -> bool:
        """Advance this rule's own message counter and decide whether to fire."""
        if self.limit >= 0 and self.fired >= self.limit:
            return False
        self.matched += 1
        hit = False
        if self.every > 0 and self.matched % self.every == 0:
            hit = True
        elif self.p > 0 and rng.random() < self.p:
            hit = True
        if hit:
            self.fired += 1
        return hit


class FaultPlan:
    """A deterministic, seedable schedule of faults for one collaboration.

    Thread-safe: rule counters and the RNG advance under a lock (replica
    pumps and read-ahead workers transmit concurrently with the workload).
    Crash/restart side effects run *outside* the lock so a crash triggered
    from a pump's own call path cannot deadlock against it.
    """

    def __init__(self, seed: int = 0):
        self.seed = seed
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._rules: List[LinkRule] = []
        #: directed blocked links: (src dc, dst dc)
        self._partitions: set = set()
        #: dtn_id -> [calls_remaining, restart_after_s]
        self._crash_at: Dict[int, List[float]] = {}
        #: append ordinal -> fraction of the record that reaches disk
        self._torn: Dict[int, float] = {}
        # configured (as-built) copies of the above: deactivate() restores
        # runtime state from these, so a healed plan re-installs as fresh
        self._partition_spec: set = set()
        self._crash_spec: Dict[int, List[float]] = {}
        self._torn_spec: Dict[int, float] = {}
        self._collab: Any = None
        self._served: Dict[int, int] = {}
        self._journal_appends = 0
        #: pending timed restarts armed by _trigger_crash (heal cancels them)
        self._timers: List[threading.Timer] = []
        #: DTNs this plan crashed (heal restarts any still down)
        self._crashed_by_plan: set = set()
        # observability: what actually fired
        self.dropped = 0
        self.dropped_replies = 0
        self.duplicated = 0
        self.delayed = 0
        self.blocked = 0
        self.crashes = 0
        self.torn_writes = 0

    # -- configuration ------------------------------------------------------

    def drop(self, src: str = "*", dst: str = "*", *, p: float = 0.0, every: int = 0,
             replies: bool = False, limit: int = -1) -> "FaultPlan":
        """Lose matching requests (or replies, with ``replies=True``)."""
        kind = "drop_reply" if replies else "drop"
        self._rules.append(LinkRule(kind, src, dst, p=p, every=every, limit=limit))
        return self

    def duplicate(self, src: str = "*", dst: str = "*", *, p: float = 0.0,
                  every: int = 0, limit: int = -1) -> "FaultPlan":
        """Deliver matching requests twice (exercises server-side dedup)."""
        self._rules.append(LinkRule("dup", src, dst, p=p, every=every, limit=limit))
        return self

    def delay(self, src: str = "*", dst: str = "*", *, extra_s: float,
              p: float = 1.0, every: int = 0, limit: int = -1) -> "FaultPlan":
        """Add ``extra_s`` of one-way latency to matching requests."""
        self._rules.append(
            LinkRule("delay", src, dst, p=p, every=every, delay_s=extra_s, limit=limit)
        )
        return self

    def partition(self, a: str, b: str, *, symmetric: bool = True) -> "FaultPlan":
        """Block the link between DCs ``a`` and ``b`` while both stay up."""
        with self._lock:
            self._partitions.add((a, b))
            self._partition_spec.add((a, b))
            if symmetric:
                self._partitions.add((b, a))
                self._partition_spec.add((b, a))
        return self

    def heal(self, a: Optional[str] = None, b: Optional[str] = None) -> "FaultPlan":
        """Lift a partition (both directions); with no args, lift them all."""
        with self._lock:
            if a is None:
                self._partitions.clear()
            else:
                self._partitions.discard((a, b))
                self._partitions.discard((b, a))
        return self

    def crash_dtn_at_call(self, dtn_id: int, nth: int,
                          restart_after_s: float = 0.0) -> "FaultPlan":
        """Crash ``dtn_id`` when its servers have served ``nth`` requests.

        With ``restart_after_s > 0`` a timer restarts the DTN after that
        outage, so retrying clients ride through a bounded failure window.
        """
        self._crash_at[dtn_id] = [nth, restart_after_s]
        self._crash_spec[dtn_id] = [nth, restart_after_s]
        return self

    def torn_journal_append(self, nth: int, keep_fraction: float = 0.5) -> "FaultPlan":
        """Tear the ``nth`` journal append (0-based): only ``keep_fraction``
        of the record's bytes reach the disk before the write fails."""
        self._torn[nth] = keep_fraction
        self._torn_spec[nth] = keep_fraction
        return self

    def bind(self, collab: Any) -> "FaultPlan":
        """Attach to a collaboration (done by ``Collaboration.install_faults``);
        enables crash-at-Nth-call to find its victim DTN by server identity."""
        self._collab = collab
        self._server_dtn: Dict[int, int] = {}
        for dtn in getattr(collab, "dtns", []):
            self._server_dtn[id(dtn.metadata_server)] = dtn.dtn_id
            self._server_dtn[id(dtn.discovery_server)] = dtn.dtn_id
        return self

    # -- runtime hooks ------------------------------------------------------

    def link_blocked(self, src: str, dst: str) -> bool:
        """Is the directed ``src -> dst`` DC link currently partitioned?"""
        with self._lock:
            return (src, dst) in self._partitions

    def on_message(self, src: str, server: Any, size: int) -> Optional[Fault]:
        """Decide the fate of one request about to cross ``src -> server``.

        Called by ``RpcClient._transmit`` with the *server object* so the
        plan can map it back to its DTN for crash triggers.  Returns ``None``
        (common case: no active faults) or a :class:`Fault` decision.
        """
        dst = getattr(server, "site", "") or ""
        crash_dtn = None
        fault: Optional[Fault] = None
        with self._lock:
            if (src, dst) in self._partitions:
                self.blocked += 1
                return Fault(blocked=True)
            for rule in self._rules:
                if not rule.matches(src, dst):
                    continue
                if not rule.decide(self._rng):
                    continue
                if fault is None:
                    fault = Fault()
                if rule.kind == "drop":
                    fault.drop_request = True
                    self.dropped += 1
                elif rule.kind == "drop_reply":
                    fault.drop_reply = True
                    self.dropped_replies += 1
                elif rule.kind == "dup":
                    fault.duplicate = True
                    self.duplicated += 1
                elif rule.kind == "delay":
                    fault.delay_s += rule.delay_s
                    self.delayed += 1
            if self._crash_at and not (fault is not None and fault.drop_request):
                dtn_id = getattr(self, "_server_dtn", {}).get(id(server))
                if dtn_id is not None and dtn_id in self._crash_at:
                    self._served[dtn_id] = self._served.get(dtn_id, 0) + 1
                    pending = self._crash_at[dtn_id]
                    if self._served[dtn_id] >= pending[0]:
                        del self._crash_at[dtn_id]
                        crash_dtn = (dtn_id, pending[1])
        if crash_dtn is not None:
            self._trigger_crash(*crash_dtn)
        return fault

    def _trigger_crash(self, dtn_id: int, restart_after_s: float) -> None:
        self.crashes += 1
        collab = self._collab
        if collab is None:
            return
        with self._lock:
            self._crashed_by_plan.add(dtn_id)
        collab.crash_dtn(dtn_id)
        if restart_after_s > 0:
            timer = threading.Timer(restart_after_s, collab.restart_dtn, args=(dtn_id,))
            timer.daemon = True
            with self._lock:
                self._timers.append(timer)
            timer.start()

    def deactivate(self) -> None:
        """Heal completely (``Collaboration.install_faults(None)`` calls this).

        Cancels pending ``crash_dtn_at_call`` timed restarts and restarts any
        DTN this plan crashed that is still down, lifts every partition, and
        resets all *schedule* state — rule matched/fired cadence counters,
        per-DTN served counts, crash triggers, torn appends, the journal
        ordinal — back to the plan's as-built configuration, so a healed
        collaboration is indistinguishable from one that never had the plan:
        re-installing this plan starts its cadence from zero with every
        configured fault re-armed.  The lifetime observability totals
        (:meth:`stats`) are deliberately preserved; they record history, not
        pending behavior.
        """
        with self._lock:
            timers, self._timers = self._timers, []
            crashed, self._crashed_by_plan = self._crashed_by_plan, set()
            self._partitions = set(self._partition_spec)
            self._crash_at = {k: list(v) for k, v in self._crash_spec.items()}
            self._torn = dict(self._torn_spec)
            self._served.clear()
            self._journal_appends = 0
            for rule in self._rules:
                rule.matched = 0
                rule.fired = 0
            collab = self._collab
        for timer in timers:
            timer.cancel()
        if collab is not None:
            for dtn_id in sorted(crashed):
                if collab.dtns[dtn_id].down:
                    collab.restart_dtn(dtn_id)

    def journal_torn_bytes(self, append_ordinal: int, frame_len: int) -> Optional[int]:
        """Torn-write hook for :class:`WriteBackJournal.append`: returns how
        many bytes of the ``append_ordinal``-th record survive (``None`` =
        write intact)."""
        with self._lock:
            frac = self._torn.pop(append_ordinal, None)
            if frac is None:
                return None
            self.torn_writes += 1
        return max(0, min(frame_len - 1, int(frame_len * frac)))

    def next_journal_ordinal(self) -> int:
        """Monotone per-plan journal append counter (shared by every journal
        under this plan, so 'the Nth append in the run' is well defined)."""
        with self._lock:
            n = self._journal_appends
            self._journal_appends += 1
        return n

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "dropped": self.dropped,
                "dropped_replies": self.dropped_replies,
                "duplicated": self.duplicated,
                "delayed": self.delayed,
                "blocked": self.blocked,
                "crashes": self.crashes,
                "torn_writes": self.torn_writes,
            }


# ---------------------------------------------------------------------------
# Canned plans — the seeded fault matrix (scripts/fault_matrix.py, fig13)
# ---------------------------------------------------------------------------


def _plan_drops(seed: int) -> FaultPlan:
    """Lossy WAN: every 7th cross-link request and every 11th reply lost."""
    return FaultPlan(seed).drop(every=7).drop(every=11, replies=True)


def _plan_flaky(seed: int) -> FaultPlan:
    """Flaky link: probabilistic drops + duplicate deliveries + jittery delay."""
    return (
        FaultPlan(seed)
        .drop(p=0.05)
        .duplicate(every=5)
        .delay(extra_s=0.0005, p=0.2)
    )


def _plan_crash(seed: int, dtn_id: int = 1, nth: int = 40,
                outage_s: float = 0.05) -> FaultPlan:
    """A DTN dies mid-workload and comes back after a bounded outage."""
    return FaultPlan(seed).crash_dtn_at_call(dtn_id, nth, restart_after_s=outage_s)


def _plan_chaos(seed: int) -> FaultPlan:
    """Drops + delays + duplicates at once (the acceptance mix, minus the
    partition/crash phases the harness drives explicitly)."""
    return (
        FaultPlan(seed)
        .drop(every=13)
        .drop(every=17, replies=True)
        .duplicate(every=11)
        .delay(extra_s=0.0003, p=0.1)
    )


def _plan_quorum(seed: int) -> FaultPlan:
    """Clean inter-DC partition: the quorum/degraded-write acceptance cell.

    Writes owned by the far DC must keep landing (journal + quorum of the
    local replica set) while the link is down, then converge byte-identically
    after ``install_faults(None)`` + ``Collaboration.reconcile()``.
    """
    return FaultPlan(seed).partition("dc0", "dc1")


def _plan_lease_expiry(seed: int) -> FaultPlan:
    """Partition plus a noisy link: exercises lease renewal under duplicate
    deliveries and jitter, so an expired/superseded lease's fencing token is
    actually refused (``RpcFenced``) rather than silently retried."""
    return (
        FaultPlan(seed)
        .partition("dc0", "dc1")
        .duplicate(every=9)
        .delay(extra_s=0.0002, p=0.1)
    )


CANNED_PLANS = {
    "drops": _plan_drops,
    "flaky": _plan_flaky,
    "crash": _plan_crash,
    "chaos": _plan_chaos,
    "quorum": _plan_quorum,
    "lease-expiry": _plan_lease_expiry,
}


def canned_plan(name: str, seed: int = 0, **kwargs: Any) -> FaultPlan:
    """Build one of the named fault plans the CI fault matrix replays."""
    try:
        factory = CANNED_PLANS[name]
    except KeyError:
        raise ValueError(f"unknown fault plan {name!r}; have {sorted(CANNED_PLANS)}")
    return factory(seed, **kwargs)
