"""Message layer for SCISPACE services.

The paper implements all component interaction with gRPC + Google Protocol
Buffers (§IV-A).  This container has neither a network nor grpc installed, so
this module provides the same *shape* of system — explicit binary message
serialization, client/server dispatch, and per-message channel costs — as an
in-process library.  The serialization cost is real (every request and reply
is packed to bytes and unpacked again, exactly the overhead the paper measures
in §IV-E "message packing and unpacking at SDS"), and the channel cost is
injectable so benchmarks can model intra-DC vs cross-DC links.

A real deployment would swap :class:`RpcClient`/:class:`RpcServer` for gRPC
stubs; every service in :mod:`repro_torch.core` talks only through this interface.

Wire-format fast path
---------------------
The wire format is unchanged (1 tag byte, type-specific payload, length-
prefixed containers) but the codec has two implementations:

* :func:`pack` — the fast path: appends into a ``bytearray`` through
  pre-bound :class:`struct.Struct` instances that fuse the tag byte with its
  payload (``<cq``/``<cd``/``<cI``), with exact-type dispatch before the
  ``isinstance`` fallback.  :func:`pack_flat` specializes further for flat
  record dicts (str keys, scalar values) — the shape replication records and
  attribute rows take — skipping recursive dispatch entirely.
* :func:`pack_recursive` — the original ``io.BytesIO`` recursive packer,
  kept as the benchmark baseline (``benchmarks/fig11_wirepath.py``) and the
  byte-for-byte reference the property tests pin the fast path against.

:func:`unpack` walks a :class:`memoryview` with integer offsets instead of a
stream object; ``str`` payloads decode straight out of the view and ``bytes``
payloads can be returned as zero-copy subviews (``copy=False``, used on the
hot request/response path).  Malformed or truncated buffers raise
:class:`CodecError` — a :class:`RpcError` *and* ``ValueError`` — carrying the
byte offset where decoding failed, and nesting is bounded by a recursion-depth
guard so hostile buffers cannot blow the interpreter stack.

Fault tolerance
---------------
A client built with a :class:`RetryPolicy` retries *unavailability* —
dropped messages, partitions, down servers, all surfaced as
:class:`RpcUnavailable` / :class:`RpcTimeout` — with exponential backoff and
decorrelated jitter, bounded by ``max_attempts``, a per-call ``deadline_s``
and a per-client retry ``budget``.  Application errors (a method raising)
never retry.  Every retried request carries the *same* idempotency token
(``rid``); :class:`RpcServer` keeps a bounded dedup window of
``rid -> packed reply`` so a retry whose original request actually executed
(reply lost on the wire) returns the cached reply instead of double-applying
the mutation.  Fault injection rides the same seam: a client constructed
with a ``faults`` provider consults the collaboration's
:class:`~repro_torch.core.faults.FaultPlan` on every transmission, which can drop,
delay, duplicate or block the message deterministically.
"""

from __future__ import annotations

import io
import random
import struct
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from .telemetry import now as _tel_now

__all__ = [
    "pack",
    "pack_flat",
    "pack_recursive",
    "unpack",
    "Channel",
    "RpcServer",
    "RpcClient",
    "RpcError",
    "CodecError",
    "RpcUnavailable",
    "RpcTimeout",
    "RpcFenced",
    "RetryPolicy",
    "RpcFuture",
    "RpcPipeline",
    "RpcStats",
]

# ---------------------------------------------------------------------------
# Binary codec (protobuf stand-in).
#
# Wire format: 1 type byte, then a type-specific payload.  Containers are
# length-prefixed.  This is a genuine serialization pass — benchmarks that
# measure "message packing overhead" measure this code.
# ---------------------------------------------------------------------------

_T_NONE = b"N"
_T_TRUE = b"T"
_T_FALSE = b"F"
_T_INT = b"I"
_T_FLOAT = b"D"
_T_STR = b"S"
_T_BYTES = b"B"
_T_LIST = b"L"
_T_DICT = b"M"

#: Maximum container nesting the codec will pack or unpack.  Messages in this
#: system are at most a handful of levels deep (batch → op → kwargs → rows);
#: anything deeper is a bug or a hostile buffer, not a workload.
_MAX_DEPTH = 32

# Pre-bound structs; the <c?> variants fuse the tag byte with its payload so a
# scalar lands in the buffer with a single append.  The bare ``.pack`` bound
# methods skip one attribute lookup per element on the hot path.
_S_I = struct.Struct("<I")
_S_TAG_INT = struct.Struct("<cq")
_S_TAG_FLOAT = struct.Struct("<cd")
_S_TAG_LEN = struct.Struct("<cI")
_S_Q = struct.Struct("<q")
_S_D = struct.Struct("<d")
_P_I = _S_I.pack
_P_TAG_INT = _S_TAG_INT.pack
_P_TAG_FLOAT = _S_TAG_FLOAT.pack
_P_TAG_LEN = _S_TAG_LEN.pack

#: Memoized wire encoding of dict keys (length prefix + utf-8 bytes).  Keys
#: are drawn from a small fixed vocabulary — method names, record fields —
#: so the cache converges after a handful of messages; the size cap only
#: guards against a pathological workload using unbounded key sets.
_KEY_CACHE: Dict[str, bytes] = {}
_KEY_CACHE_MAX = 4096

#: Memoized wire encoding of *short string values* (tag + length + utf-8).
#: Metadata traffic repeats the same strings constantly — attribute names
#: and type tags in index rows, owners/DC ids in entries, and every path
#: re-shipped once per replica peer — so most string fields reduce to one
#: dict hit and one buffer append.  Long strings (> 64 chars) bypass the
#: cache: they amortize their encode cost and would evict useful entries.
_STR_CACHE: Dict[str, bytes] = {}
_STR_CACHE_MAX = 4096
_STR_CACHE_MAXLEN = 64


def _key_bytes(key: Any) -> bytes:
    if not isinstance(key, str):
        raise TypeError(f"message dict keys must be str, got {type(key)!r}")
    raw = key.encode("utf-8")
    enc = _P_I(len(raw)) + raw
    if len(_KEY_CACHE) < _KEY_CACHE_MAX:
        _KEY_CACHE[key] = enc
    return enc


def _str_bytes(value: str) -> bytes:
    raw = value.encode("utf-8")
    enc = _P_TAG_LEN(_T_STR, len(raw)) + raw
    if len(value) <= _STR_CACHE_MAXLEN and len(_STR_CACHE) < _STR_CACHE_MAX:
        _STR_CACHE[value] = enc
    return enc


class RpcError(RuntimeError):
    """A remote call failed; carries the remote exception message."""


class RpcUnavailable(RpcError):
    """The peer could not be reached (down server, dropped message,
    partitioned link, open circuit breaker).  The *retryable* failure class:
    the request may or may not have executed, which is exactly why retried
    requests carry idempotency tokens."""


class RpcTimeout(RpcUnavailable):
    """A message (request or reply) was lost and the call timed out waiting."""


class RpcFenced(RpcError):
    """The request's fencing token is stale: a newer write lease exists for
    the path prefix, so the server refused to dispatch the mutation.

    Deliberately *not* an :class:`RpcUnavailable` — the peer answered, it
    just said no.  Retrying with the same token can never succeed (fence
    floors only rise), so retry policies must not ride through this; the
    holder has to re-acquire its lease and mint a fresh token.
    """


class CodecError(RpcError, ValueError):
    """Malformed, truncated, or over-nested wire buffer.

    Subclasses both :class:`RpcError` (so RPC-layer callers see one failure
    type) and ``ValueError`` (so pre-existing recovery code that catches
    ``(ValueError, struct.error)`` — e.g. the write-back journal's torn-tail
    scan — keeps working).  The message carries the byte offset at which
    decoding failed.
    """


def _pack_scalar(out: bytearray, obj: Any) -> bool:
    """Append one scalar to ``out``; return ``False`` for non-scalars."""
    t = type(obj)
    if obj is None:
        out += _T_NONE
    elif obj is True:
        out += _T_TRUE
    elif obj is False:
        out += _T_FALSE
    elif t is int:
        out += _S_TAG_INT.pack(_T_INT, obj)
    elif t is float:
        out += _S_TAG_FLOAT.pack(_T_FLOAT, obj)
    elif t is str:
        raw = obj.encode("utf-8")
        out += _S_TAG_LEN.pack(_T_STR, len(raw))
        out += raw
    elif t is bytes or t is bytearray or t is memoryview:
        out += _S_TAG_LEN.pack(_T_BYTES, len(obj))
        out += obj
    elif isinstance(obj, int):  # int subclasses (IntEnum, ...)
        out += _S_TAG_INT.pack(_T_INT, int(obj))
    elif isinstance(obj, float):  # float subclasses (np.float64, ...)
        out += _S_TAG_FLOAT.pack(_T_FLOAT, float(obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        out += _S_TAG_LEN.pack(_T_STR, len(raw))
        out += raw
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        out += _S_TAG_LEN.pack(_T_BYTES, len(raw))
        out += raw
    else:
        return False
    return True


def _pack_into(out: bytearray, obj: Any, depth: int = 0) -> None:
    # The scalar dispatch is INLINED inside both container loops: a function
    # call per element is exactly the overhead that made the recursive packer
    # slow, so the hot loops pay only an exact-class check and one fused
    # Struct append per value.  Anything unusual (scalar subclasses, nested
    # containers) falls through to the full dispatch below / recursion.
    t = obj.__class__
    if t is dict:
        if depth >= _MAX_DEPTH:
            raise CodecError(f"message nesting exceeds depth limit {_MAX_DEPTH}")
        out += _P_TAG_LEN(_T_DICT, len(obj))
        depth += 1
        key_cache = _KEY_CACHE
        str_cache = _STR_CACHE
        for key, value in obj.items():
            enc = key_cache.get(key)
            out += enc if enc is not None else _key_bytes(key)
            vt = value.__class__
            if vt is str:
                enc = str_cache.get(value)
                out += enc if enc is not None else _str_bytes(value)
            elif vt is int:
                out += _P_TAG_INT(_T_INT, value)
            elif vt is bool:
                out += _T_TRUE if value else _T_FALSE
            elif value is None:
                out += _T_NONE
            elif vt is float:
                out += _P_TAG_FLOAT(_T_FLOAT, value)
            else:
                _pack_into(out, value, depth)
        return
    if t is list or t is tuple:
        if depth >= _MAX_DEPTH:
            raise CodecError(f"message nesting exceeds depth limit {_MAX_DEPTH}")
        out += _P_TAG_LEN(_T_LIST, len(obj))
        depth += 1
        str_cache = _STR_CACHE
        for value in obj:
            vt = value.__class__
            if vt is str:
                enc = str_cache.get(value)
                out += enc if enc is not None else _str_bytes(value)
            elif vt is int:
                out += _P_TAG_INT(_T_INT, value)
            elif vt is bool:
                out += _T_TRUE if value else _T_FALSE
            elif value is None:
                out += _T_NONE
            elif vt is float:
                out += _P_TAG_FLOAT(_T_FLOAT, value)
            else:
                _pack_into(out, value, depth)
        return
    if _pack_scalar(out, obj):
        return
    raise TypeError(f"unsupported message field type: {type(obj)!r}")


def pack(obj: Any) -> bytes:
    """Serialize a message object (nested dict/list of primitives) to bytes."""
    out = bytearray()
    _pack_into(out, obj)
    return bytes(out)


def pack_flat(record: Dict[str, Any]) -> bytes:
    """Non-recursive :func:`pack` for flat record dicts (str → scalar).

    Byte-identical to ``pack(record)``; raises :class:`CodecError` if any
    value is a container (callers fall back to :func:`pack`).  This is the
    shape replication log records and attribute rows take on the wire, so the
    pump and journal hit this path for the bulk of shipped bytes.
    """
    out = bytearray()
    out += _P_TAG_LEN(_T_DICT, len(record))
    key_cache = _KEY_CACHE
    str_cache = _STR_CACHE
    for key, value in record.items():
        enc = key_cache.get(key)
        out += enc if enc is not None else _key_bytes(key)
        vt = value.__class__
        if vt is str:
            enc = str_cache.get(value)
            out += enc if enc is not None else _str_bytes(value)
        elif vt is int:
            out += _P_TAG_INT(_T_INT, value)
        elif vt is bool:
            out += _T_TRUE if value else _T_FALSE
        elif value is None:
            out += _T_NONE
        elif vt is float:
            out += _P_TAG_FLOAT(_T_FLOAT, value)
        elif not _pack_scalar(out, value):
            raise CodecError(
                f"pack_flat: container value for key {key!r} ({type(value).__name__}); "
                "use pack() for nested messages"
            )
    return bytes(out)


def _pack_into_recursive(buf: io.BytesIO, obj: Any) -> None:
    if obj is None:
        buf.write(_T_NONE)
    elif obj is True:
        buf.write(_T_TRUE)
    elif obj is False:
        buf.write(_T_FALSE)
    elif isinstance(obj, int):
        buf.write(_T_INT)
        buf.write(struct.pack("<q", obj))
    elif isinstance(obj, float):
        buf.write(_T_FLOAT)
        buf.write(struct.pack("<d", obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        buf.write(_T_STR)
        buf.write(struct.pack("<I", len(raw)))
        buf.write(raw)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        buf.write(_T_BYTES)
        buf.write(struct.pack("<I", len(raw)))
        buf.write(raw)
    elif isinstance(obj, (list, tuple)):
        buf.write(_T_LIST)
        buf.write(struct.pack("<I", len(obj)))
        for item in obj:
            _pack_into_recursive(buf, item)
    elif isinstance(obj, dict):
        buf.write(_T_DICT)
        buf.write(struct.pack("<I", len(obj)))
        for key, value in obj.items():
            if not isinstance(key, str):
                raise TypeError(f"message dict keys must be str, got {type(key)!r}")
            raw = key.encode("utf-8")
            buf.write(struct.pack("<I", len(raw)))
            buf.write(raw)
            _pack_into_recursive(buf, value)
    else:
        raise TypeError(f"unsupported message field type: {type(obj)!r}")


def pack_recursive(obj: Any) -> bytes:
    """The original stream-based recursive packer (fig11 baseline).

    Kept verbatim so benchmarks can measure the fast path against the exact
    code the seed shipped, and so property tests can pin byte-for-byte
    equality between the two implementations.
    """
    buf = io.BytesIO()
    _pack_into_recursive(buf, obj)
    return buf.getvalue()


def _need(mv: memoryview, pos: int, n: int, what: str) -> int:
    """Bounds-check ``n`` bytes at ``pos``; return the new offset."""
    end = pos + n
    if end > len(mv):
        raise CodecError(
            f"truncated message: need {n} byte(s) for {what} at offset {pos}, "
            f"have {len(mv) - pos}"
        )
    return end


def _unpack_from(mv: memoryview, pos: int, depth: int, copy: bool) -> Tuple[Any, int]:
    end = _need(mv, pos, 1, "tag")
    tag = mv[pos]
    pos = end
    if tag == 0x4E:  # N — None
        return None, pos
    if tag == 0x54:  # T — True
        return True, pos
    if tag == 0x46:  # F — False
        return False, pos
    if tag == 0x49:  # I — int64
        end = _need(mv, pos, 8, "int payload")
        return _S_Q.unpack_from(mv, pos)[0], end
    if tag == 0x44:  # D — float64
        end = _need(mv, pos, 8, "float payload")
        return _S_D.unpack_from(mv, pos)[0], end
    if tag == 0x53:  # S — str
        end = _need(mv, pos, 4, "str length")
        (n,) = _S_I.unpack_from(mv, pos)
        pos, end = end, _need(mv, end, n, "str payload")
        try:
            return str(mv[pos:end], "utf-8"), end
        except UnicodeDecodeError as exc:
            raise CodecError(f"corrupt str payload at offset {pos}: {exc}") from exc
    if tag == 0x42:  # B — bytes
        end = _need(mv, pos, 4, "bytes length")
        (n,) = _S_I.unpack_from(mv, pos)
        pos, end = end, _need(mv, end, n, "bytes payload")
        return (mv[pos:end] if not copy else bytes(mv[pos:end])), end
    if tag == 0x4C:  # L — list
        if depth >= _MAX_DEPTH:
            raise CodecError(f"message nesting exceeds depth limit {_MAX_DEPTH} at offset {pos - 1}")
        end = _need(mv, pos, 4, "list length")
        (n,) = _S_I.unpack_from(mv, pos)
        pos = end
        out_list = []
        append = out_list.append
        for _ in range(n):
            item, pos = _unpack_from(mv, pos, depth + 1, copy)
            append(item)
        return out_list, pos
    if tag == 0x4D:  # M — dict
        if depth >= _MAX_DEPTH:
            raise CodecError(f"message nesting exceeds depth limit {_MAX_DEPTH} at offset {pos - 1}")
        end = _need(mv, pos, 4, "dict length")
        (n,) = _S_I.unpack_from(mv, pos)
        pos = end
        out: Dict[str, Any] = {}
        for _ in range(n):
            end = _need(mv, pos, 4, "key length")
            (k,) = _S_I.unpack_from(mv, pos)
            pos, end = end, _need(mv, end, k, "key payload")
            try:
                key = str(mv[pos:end], "utf-8")
            except UnicodeDecodeError as exc:
                raise CodecError(f"corrupt dict key at offset {pos}: {exc}") from exc
            pos = end
            out[key], pos = _unpack_from(mv, pos, depth + 1, copy)
        return out, pos
    raise CodecError(f"corrupt message: unknown tag {bytes((tag,))!r} at offset {pos - 1}")


def unpack(data: Any, *, copy: bool = True) -> Any:
    """Inverse of :func:`pack`.

    Walks a :class:`memoryview` over ``data`` with integer offsets — no
    stream object, no per-field ``read`` calls.  With ``copy=False``, bytes
    payloads come back as zero-copy subviews of ``data`` (valid as long as
    ``data`` is; the RPC hot path uses this since request/response buffers
    outlive their dispatch).  Truncated or malformed input raises
    :class:`CodecError` with the failing byte offset.
    """
    mv = data if isinstance(data, memoryview) else memoryview(data)
    obj, _pos = _unpack_from(mv, 0, 0, copy)
    return obj


# ---------------------------------------------------------------------------
# Channels: model the link a message crosses.
# ---------------------------------------------------------------------------


@dataclass
class Channel:
    """A (simulated) network link with latency and bandwidth.

    ``latency_s`` is the one-way per-message latency; ``gbps`` the link
    *capacity* in gigabits/s.  Zero latency + infinite bandwidth (the
    default) makes transmission free while the serialization cost stays real.

    ``stream_gbps`` models the per-stream achievable rate: one flow over a
    long-RTT WAN link is window-bound far below link capacity (the reason
    GridFTP/bbcp move data over parallel streams), so a single transfer runs
    at ``min(gbps, stream_gbps)`` while the link itself can carry more.  The
    data plane exploits the gap with :meth:`split` — N *lanes* that share the
    link capacity (``gbps / n`` each, still window-bound per lane) but
    overlap their ``latency_s``, so striped transfers aggregate up to
    ``min(gbps, n * stream_gbps)`` instead of teleporting bytes.
    """

    name: str = "local"
    latency_s: float = 0.0
    gbps: float = float("inf")
    stream_gbps: float = float("inf")

    def rate_gbps(self) -> float:
        """Effective per-stream rate: capacity capped by the stream window."""
        return min(self.gbps, self.stream_gbps)

    def payload_seconds(self, payload_len: int) -> float:
        """Serialization time of a payload at the per-stream rate (no latency)."""
        rate = self.rate_gbps()
        if rate != float("inf") and rate > 0:
            return (payload_len * 8) / (rate * 1e9)
        return 0.0

    def delay_for(self, payload_len: int) -> float:
        """The modeled one-way delay for a payload, without sleeping."""
        return self.latency_s + self.payload_seconds(payload_len)

    def transmit(self, payload_len: int) -> None:
        delay = self.delay_for(payload_len)
        if delay > 0:
            time.sleep(delay)

    def split(self, n: int) -> List["Channel"]:
        """The lane model: ``n`` concurrent lanes over this link.

        Lanes *share* the link capacity (``gbps / n`` each — striping never
        creates bandwidth) but each lane keeps the full ``latency_s`` and its
        own ``stream_gbps`` window, so per-lane latencies and window-bound
        stream rates overlap instead of serializing.  The data plane
        round-robins stripe chunks over the lanes and pays the makespan of
        the slowest lane (:mod:`repro_torch.core.datapath`).
        """
        n = max(1, int(n))
        gbps_each = self.gbps / n if self.gbps != float("inf") else float("inf")
        return [
            Channel(
                name=f"{self.name}/lane{i}",
                latency_s=self.latency_s,
                gbps=gbps_each,
                stream_gbps=self.stream_gbps,
            )
            for i in range(n)
        ]


#: A free channel for purely in-process wiring.
LOOPBACK = Channel(name="loopback")


@dataclass(frozen=True)
class RetryPolicy:
    """Retry schedule for *unavailability* failures on one client.

    ``timeout_s`` is the modeled cost of discovering a lost message (how long
    the caller waits before concluding the request or reply is gone) — it is
    slept, like channel delays, so fault benchmarks measure realistic goodput.
    Backoff is exponential with decorrelated jitter (``sleep = min(cap_s,
    uniform(base_s, prev_sleep * 3))``), bounded three ways: ``max_attempts``
    total tries per call, a per-call ``deadline_s`` the next backoff may not
    overshoot, and a per-client retry ``budget`` so a melting-down peer can't
    absorb unbounded retry traffic.  ``seed`` makes jitter deterministic per
    client (clients mix in their ordinal) for reproducible fault runs.
    """

    max_attempts: int = 4
    base_s: float = 0.002
    cap_s: float = 0.1
    timeout_s: float = 0.002
    deadline_s: float = 2.0
    budget: int = 1000
    seed: int = 0


# ---------------------------------------------------------------------------
# Client / server
# ---------------------------------------------------------------------------


@dataclass
class RpcStats:
    """Per-client running counters (used by benchmarks + EXPERIMENTS.md).

    ``calls`` counts channel round-trips; ``ops`` counts service operations.
    For a single :meth:`RpcClient.call` they advance together; a batched call
    advances ``calls`` by one and ``ops`` by the batch size — the exact ratio
    the metadata plane exists to improve.
    """

    calls: int = 0
    ops: int = 0
    bytes_sent: int = 0
    bytes_received: int = 0
    pack_seconds: float = 0.0
    wire_seconds: float = 0.0
    #: transmissions re-sent after an unavailability failure
    retries: int = 0
    #: lost-message / down-peer events observed (each may or may not retry)
    timeouts: int = 0
    #: calls that failed with unavailability after exhausting the policy
    failures: int = 0
    #: failures where the per-client retry *budget* (not attempts/deadline)
    #: was the bound that tripped — the signal a peer is melting down faster
    #: than the schedule can absorb
    budget_exhausted: int = 0

    def snapshot(self) -> Dict[str, float]:
        return {
            "calls": self.calls,
            "ops": self.ops,
            "bytes_sent": self.bytes_sent,
            "bytes_received": self.bytes_received,
            "pack_seconds": self.pack_seconds,
            "wire_seconds": self.wire_seconds,
            "retries": self.retries,
            "timeouts": self.timeouts,
            "failures": self.failures,
            "budget_exhausted": self.budget_exhausted,
        }


class RpcServer:
    """Dispatches packed requests onto a service object's public methods.

    Envelopes are epoch-stamped when the server carries a ``clock`` (the
    DTN's Lamport :class:`~repro_torch.core.replication.EpochClock`): request
    epochs are observed (merge rule) and every reply carries the server's
    current epoch, so clients accumulate a per-server high-water mark —
    the freshness bar replica reads are judged against.  ``down`` simulates
    a crashed/partitioned DTN: every request fails with an RpcError.

    Requests carrying an idempotency token (``rid``, attached by clients
    running under a :class:`RetryPolicy`) are deduplicated through a bounded
    LRU window of ``rid -> packed reply``: a duplicate delivery — a network
    dup, or a retry whose original executed but whose reply was lost —
    returns the cached reply bytes without re-dispatching, so retried
    mutations apply exactly once.  ``deduped`` counts suppressed replays;
    ``dedup_evictions`` counts rids aged out of the window (an eviction
    narrows the exactly-once guarantee for very late replays).

    Requests carrying a ``fence`` field (``{"prefix", "token"}``, attached
    by lease holders) are admitted through ``fences`` (the DTN's
    :class:`~repro_torch.core.leases.LeaseTable`): a token below the prefix's
    fence floor means a newer lease was granted since this holder's, so the
    mutation is refused *before* dispatch — it never reaches the service or
    the replication log.  The fenced refusal is still rid-cached so a
    retried stale mutation is refused, not re-evaluated.

    Requests carrying a ``trace`` field (``[trace_id, parent_span_id]``,
    attached by tracing clients) record a server-side span into this DTN's
    ``telemetry`` buffer: ``apply.<method>`` (or ``apply.batch``) for
    dispatched work, ``rpc.fenced`` with status ``fenced`` for fence-floor
    refusals.  Dedup-window hits return the cached reply *without* a span —
    an assembled trace therefore shows exactly one apply span per rid no
    matter how many times the mutation was delivered.
    """

    def __init__(
        self,
        service: Any,
        name: str = "service",
        clock: Any = None,
        *,
        site: str = "",
        dedup_window: int = 1024,
        fences: Any = None,
        telemetry: Any = None,
    ):
        self._service = service
        self.name = name
        self.clock = clock
        self.down = False
        #: dc_id this server lives in — the fault plane keys link rules on it
        self.site = site
        self.dedup_window = dedup_window
        self.requests = 0
        self.deduped = 0
        self.dedup_evictions = 0
        #: fence-floor authority (LeaseTable) shared by this DTN's servers
        self.fences = fences
        self.fenced_rejections = 0
        #: the DTN's Telemetry bundle (span buffer server spans land in)
        self.telemetry = telemetry
        self._dedup: "OrderedDict[str, bytes]" = OrderedDict()
        self._lock = threading.Lock()

    def _trace_ctx(self, req: Dict[str, Any]) -> Optional[Tuple[int, int]]:
        """Parent context from the envelope, when this server traces.

        The envelope carries ``trace`` as an ``[trace_id, span_id]`` int pair —
        a single codec op on the hot path instead of a list of two."""
        if self.telemetry is None:
            return None
        trace = req.get("trace")
        if trace is None:
            return None
        return (trace[0], trace[1])

    def handle(self, request: bytes) -> bytes:
        if self.down:
            return pack({"ok": False, "error": f"ServiceDown: {self.name} is unreachable"})
        # zero-copy: bytes payloads (file writes, scidata blobs) dispatch into
        # the service as subviews of the request buffer, never re-copied
        req = unpack(request, copy=False)
        self.requests += 1
        rid = req.get("rid")
        if rid is not None:
            with self._lock:
                cached = self._dedup.get(rid)
                if cached is not None:
                    self._dedup.move_to_end(rid)
            if cached is not None:
                self.deduped += 1
                return cached
        if self.clock is not None and req.get("epoch"):
            self.clock.observe(int(req["epoch"]))
        fence = req.get("fence")
        if fence is not None and self.fences is not None and not self.fences.admit(
            str(fence.get("prefix", "/")), int(fence.get("token", 0))
        ):
            self.fenced_rejections += 1
            ctx = self._trace_ctx(req)
            if ctx is not None:
                # deliberately NOT an ``apply.*`` name: a fenced trace tree
                # must show the refusal with no shard-apply child
                self.telemetry.tracer.record(
                    "rpc.fenced", parent=ctx, status="fenced",
                    tags={"rid": rid, "prefix": fence.get("prefix")},
                )
            reply = {
                "ok": False,
                "fenced": True,
                "error": (
                    f"FencedWrite: token {fence.get('token')} below fence floor "
                    f"for {fence.get('prefix')!r} (a newer lease was granted)"
                ),
            }
            if self.clock is not None:
                reply["epoch"] = self.clock.last_local()
            out = pack(reply)
            if rid is not None:
                with self._lock:
                    self._dedup[rid] = out
                    while len(self._dedup) > self.dedup_window:
                        self._dedup.popitem(last=False)
                        self.dedup_evictions += 1
            return out
        ctx = self._trace_ctx(req)
        t_apply = _tel_now() if ctx is not None else 0.0
        if "batch" in req:
            # One channel round-trip, N operations, executed strictly in list
            # order on this server.  Each op gets its own ok/error slot so one
            # failure neither aborts the batch nor masks later results.
            reply = {"ok": True, "results": [self._dispatch(op) for op in req["batch"]]}
        else:
            reply = self._dispatch(req)
        if ctx is not None:
            name = "apply.batch" if "batch" in req else f"apply.{req.get('method')}"
            self.telemetry.tracer.record(
                name,
                parent=ctx,
                status="ok" if reply.get("ok", True) else "error",
                start=t_apply,
                tags={"rid": rid} if rid is not None else None,
            )
        if self.clock is not None:
            # the freshness bar: this origin's own last mutation, not the
            # merged Lamport value (see EpochClock.last_local)
            reply["epoch"] = self.clock.last_local()
        out = pack(reply)
        if rid is not None:
            with self._lock:
                self._dedup[rid] = out
                while len(self._dedup) > self.dedup_window:
                    self._dedup.popitem(last=False)
                    self.dedup_evictions += 1
        return out

    def _dispatch(self, req: Dict[str, Any]) -> Dict[str, Any]:
        method = req["method"]
        kwargs = req.get("kwargs") or {}
        if method.startswith("_"):
            return {"ok": False, "error": f"no such method: {method}"}
        fn: Optional[Callable] = getattr(self._service, method, None)
        if fn is None or not callable(fn):
            return {"ok": False, "error": f"no such method: {method}"}
        try:
            return {"ok": True, "result": fn(**kwargs)}
        except Exception as exc:  # noqa: BLE001 - faithfully forwarded to client
            return {"ok": False, "error": f"{type(exc).__name__}: {exc}"}


class RpcFuture:
    """Result slot for one pipelined operation; resolved when its batch flushes."""

    __slots__ = ("_result", "_error", "_done")

    def __init__(self) -> None:
        self._result: Any = None
        self._error: Optional[RpcError] = None
        self._done = False

    def _resolve(self, reply: Dict[str, Any]) -> None:
        if reply.get("ok"):
            self._result = reply.get("result")
        else:
            self._error = RpcError(reply.get("error", "unknown remote error"))
        self._done = True

    def done(self) -> bool:
        return self._done

    def exception(self) -> Optional[RpcError]:
        if not self._done:
            raise RuntimeError("pipeline not flushed; result not available yet")
        return self._error

    def result(self) -> Any:
        err = self.exception()
        if err is not None:
            raise err
        return self._result


class RpcClient:
    """Client stub: packs the call, crosses the channel both ways, unpacks.

    With a :class:`RetryPolicy`, every call carries an idempotency token and
    unavailability (down peer, dropped message, partition) is retried with
    backoff until the policy's attempt/deadline/budget bounds trip; without
    one the client fails fast exactly as before.  ``faults`` is a zero-arg
    provider returning the active :class:`~repro_torch.core.faults.FaultPlan` (or
    ``None``) — a provider rather than the plan itself so plans installed
    after client construction still take effect.
    """

    _ordinal = 0
    _ordinal_lock = threading.Lock()

    def __init__(
        self,
        server: RpcServer,
        channel: Channel = LOOPBACK,
        *,
        site: str = "",
        retry: Optional[RetryPolicy] = None,
        faults: Optional[Callable[[], Any]] = None,
        tracer: Any = None,
        metrics: Any = None,
    ):
        self._server = server
        self.channel = channel
        self.stats = RpcStats()
        #: dc_id this client calls from; the fault plane keys link rules on
        #: the (client site -> server site) pair
        self.site = site
        self.retry = retry
        self._faults = faults
        #: plane Tracer — when set and a trace context is active on this
        #: thread, every round-trip records a client span and propagates
        #: ``trace=[tid, sid]`` on the envelope (next to epoch/rid/fence)
        self.tracer = tracer
        self._lat_hist = metrics.histogram("rpc.call_seconds") if metrics is not None else None
        #: highest epoch witnessed in this server's reply envelopes — the
        #: session-consistency bar for replica reads of rows it originates
        self.last_epoch = 0
        # reusable request framer: capacity persists across calls, so batch
        # frames stop paying per-call buffer growth once warmed up
        self._frame = bytearray()
        with RpcClient._ordinal_lock:
            ordinal = RpcClient._ordinal
            RpcClient._ordinal += 1
        if retry is not None:
            self._rid_prefix = f"c{ordinal}"
            self._rid_seq = 0
            self._retry_budget = retry.budget
            # decorrelated jitter, deterministic per (policy seed, client)
            self._retry_rng = random.Random(f"{retry.seed}:{ordinal}")

    def _lost(self, why: str) -> None:
        """A message went missing: pay the modeled detection cost and raise."""
        self.stats.timeouts += 1
        policy = self.retry
        if policy is not None and policy.timeout_s > 0:
            time.sleep(policy.timeout_s)
        raise RpcTimeout(why)

    def _transmit(self, request: bytes, defer_wire: bool) -> Tuple[bytes, float]:
        """One attempt: cross the channel, dispatch, cross back.

        Consults the fault plan (if any) before touching the wire; raises
        :class:`RpcTimeout` for lost messages / partitions and
        :class:`RpcUnavailable` for a down server.  A *duplicate* delivery
        dispatches the same request twice — the server's dedup window is what
        keeps the second apply from happening.
        """
        fx = None
        plan = self._faults() if self._faults is not None else None
        if plan is not None:
            fx = plan.on_message(self.site, self._server, len(request))
            if fx is not None:
                if fx.blocked:
                    self._lost(
                        f"link {self.site or '?'}->{self._server.site or '?'} partitioned"
                    )
                if fx.drop_request:
                    self._lost(f"request to {self._server.name} dropped")
        if self._server.down:
            # a dead peer never answers; surfaced as unavailability so the
            # retry policy (not the application) owns what happens next
            self._lost(f"ServiceDown: {self._server.name} is unreachable")
        delay_s = fx.delay_s if fx is not None else 0.0
        if defer_wire:
            wire = delay_s + self.channel.delay_for(len(request))
            response = self._server.handle(request)
            if fx is not None and fx.duplicate:
                self._server.handle(request)
            wire += self.channel.delay_for(len(response))
        else:
            t0 = time.perf_counter()
            if delay_s > 0:
                time.sleep(delay_s)
            self.channel.transmit(len(request))
            response = self._server.handle(request)
            if fx is not None and fx.duplicate:
                self._server.handle(request)
            self.channel.transmit(len(response))
            wire = time.perf_counter() - t0
        if fx is not None and fx.drop_reply:
            self._lost(f"reply from {self._server.name} dropped")
        return response, wire

    def _round_trip(
        self, message: Dict[str, Any], n_ops: int, defer_wire: bool = False
    ) -> Tuple[Dict[str, Any], float]:
        """Pack, cross the channel both ways, dispatch, unpack.

        With ``defer_wire=True`` the channel delays are *computed and
        returned* instead of slept — the plane's scatter-gather uses this to
        model N links in flight at once: it issues the calls back-to-back and
        sleeps once for the slowest window, the wall-clock a real concurrent
        fan-out would pay (per-thread sub-ms sleeps neither overlap nor stay
        accurate under this container's timer granularity + GIL).
        """
        t0 = time.perf_counter()
        if self.last_epoch:
            message = dict(message, epoch=self.last_epoch)
        policy = self.retry
        if policy is not None:
            # same rid across every retry of this call — that identity is
            # what the server's dedup window keys exactly-once on
            self._rid_seq += 1
            message = dict(message, rid=f"{self._rid_prefix}.{self._rid_seq}")
        tracer = self.tracer
        span = None
        if tracer is not None and tracer.enabled:
            parent = tracer.current()
            if parent is not None:
                # leaf span, never on the context stack: server-side children
                # parent to it through the envelope, not thread-locals
                span = tracer.start_span(
                    f"rpc.{message.get('method') or 'batch'}", parent=parent
                )
                message = dict(message, trace=[span.trace_id, span.span_id])
        frame = self._frame
        del frame[:]
        _pack_into(frame, message)
        request = bytes(frame)
        t1 = time.perf_counter()
        retried = False
        if policy is None:
            try:
                response, wire = self._transmit(request, defer_wire)
            except RpcUnavailable:
                self.stats.failures += 1
                if span is not None:
                    tracer.finish(span, status="unavailable")
                raise
        else:
            deadline = t1 + policy.deadline_s
            backoff = policy.base_s
            attempt = 1
            while True:
                try:
                    response, wire = self._transmit(request, defer_wire)
                    break
                except RpcUnavailable:
                    backoff = min(
                        policy.cap_s, self._retry_rng.uniform(policy.base_s, backoff * 3)
                    )
                    out_of_budget = self._retry_budget <= 0
                    if (
                        attempt >= policy.max_attempts
                        or out_of_budget
                        or time.perf_counter() + backoff > deadline
                    ):
                        self.stats.failures += 1
                        if out_of_budget:
                            self.stats.budget_exhausted += 1
                        if span is not None:
                            if span.tags is None:
                                span.tags = {}
                            span.tags["attempts"] = attempt
                            tracer.finish(span, status="unavailable")
                        raise
                    attempt += 1
                    retried = True
                    self._retry_budget -= 1
                    self.stats.retries += 1
                    if backoff > 0:
                        time.sleep(backoff)
        t2 = time.perf_counter()
        resp = unpack(response, copy=False)
        t3 = time.perf_counter()
        if resp.get("epoch"):
            self.last_epoch = max(self.last_epoch, int(resp["epoch"]))

        self.stats.calls += 1
        self.stats.ops += n_ops
        self.stats.bytes_sent += len(request)
        self.stats.bytes_received += len(response)
        self.stats.pack_seconds += (t1 - t0) + (t3 - t2)
        self.stats.wire_seconds += wire
        if span is not None:
            status = "fenced" if resp.get("fenced") else ("retried" if retried else "ok")
            tracer.finish(span, status=status, wire_s=wire)
        if self._lat_hist is not None:
            # deferred wire is modeled, not slept — fold it into the observed
            # latency so histograms reflect the wall-clock a real WAN would pay
            self._lat_hist.observe((t3 - t0) + (wire if defer_wire else 0.0))
        return resp, (wire if defer_wire else 0.0)

    def call(self, method: str, **kwargs: Any) -> Any:
        resp, _ = self._round_trip({"method": method, "kwargs": kwargs}, n_ops=1)
        if not resp.get("ok"):
            if resp.get("fenced"):
                raise RpcFenced(resp.get("error", "stale fencing token"))
            raise RpcError(resp.get("error", "unknown remote error"))
        return resp.get("result")

    def call_fenced(self, fence: Dict[str, Any], method: str, **kwargs: Any) -> Any:
        """:meth:`call` with a fencing token on the envelope.

        ``fence`` is ``{"prefix": str, "token": int}`` from a held write
        lease; the server refuses dispatch with :class:`RpcFenced` when the
        token is below the prefix's fence floor (a newer lease exists).
        """
        resp, _ = self._round_trip(
            {"method": method, "kwargs": kwargs, "fence": dict(fence)}, n_ops=1
        )
        if not resp.get("ok"):
            if resp.get("fenced"):
                raise RpcFenced(resp.get("error", "stale fencing token"))
            raise RpcError(resp.get("error", "unknown remote error"))
        return resp.get("result")

    def call_deferred(self, method: str, **kwargs: Any) -> Tuple[Any, float]:
        """Like :meth:`call` but returns ``(result, modeled_wire_delay_s)``
        without sleeping; the caller owns when/whether to pay the delay."""
        resp, wire = self._round_trip(
            {"method": method, "kwargs": kwargs}, n_ops=1, defer_wire=True
        )
        if not resp.get("ok"):
            if resp.get("fenced"):
                raise RpcFenced(resp.get("error", "stale fencing token"))
            raise RpcError(resp.get("error", "unknown remote error"))
        return resp.get("result"), wire

    def call_batch(
        self,
        calls: Sequence[Tuple[str, Dict[str, Any]]],
        *,
        return_exceptions: bool = False,
    ) -> List[Any]:
        """N operations over one channel round-trip, executed in order.

        Each op still pays its own serialization (the message carries every
        request and every reply) but the channel latency is paid once — the
        coalescing the paper's MEU applies to exports (§III-B3), generalized
        to any service method.

        With ``return_exceptions=False`` the first failed op raises
        :class:`RpcError` (later ops have still executed server-side); with
        ``True`` failed slots hold the :class:`RpcError` instance instead.
        """
        results, wire = self.call_batch_deferred(calls, return_exceptions=return_exceptions)
        if wire > 0:
            time.sleep(wire)
        return results

    def call_batch_deferred(
        self,
        calls: Sequence[Tuple[str, Dict[str, Any]]],
        *,
        return_exceptions: bool = False,
    ) -> Tuple[List[Any], float]:
        """:meth:`call_batch` with the wire delay returned instead of slept."""
        if not calls:
            return [], 0.0
        message = {"batch": [{"method": m, "kwargs": kw} for m, kw in calls]}
        resp, wire = self._round_trip(message, n_ops=len(calls), defer_wire=True)
        if not resp.get("ok"):
            raise RpcError(resp.get("error", "unknown remote error"))
        replies = resp.get("results") or []
        if len(replies) != len(calls):
            raise RpcError(f"batch reply count {len(replies)} != request count {len(calls)}")
        out: List[Any] = []
        first_error: Optional[RpcError] = None
        for reply in replies:
            if reply.get("ok"):
                out.append(reply.get("result"))
            else:
                err = RpcError(reply.get("error", "unknown remote error"))
                if not return_exceptions and first_error is None:
                    first_error = err
                out.append(err)
        if first_error is not None:
            raise first_error
        return out, wire

    def pipeline(self) -> "RpcPipeline":
        """Open a pipeline: queue ops now, pay one round-trip at flush."""
        return RpcPipeline(self)


class RpcPipeline:
    """Pipelined calls on one client: futures resolve at :meth:`flush`.

    Usable as a context manager; exiting the ``with`` block flushes.  Queued
    operations execute in submission order on the remote service.
    """

    def __init__(self, client: RpcClient):
        self._client = client
        self._queued: List[Tuple[str, Dict[str, Any]]] = []
        self._futures: List[RpcFuture] = []

    def submit(self, method: str, **kwargs: Any) -> RpcFuture:
        fut = RpcFuture()
        self._queued.append((method, kwargs))
        self._futures.append(fut)
        return fut

    def __len__(self) -> int:
        return len(self._queued)

    def flush(self) -> List[RpcFuture]:
        """Send everything queued as one batch; resolve and return the futures."""
        if not self._queued:
            return []
        calls, futures = self._queued, self._futures
        self._queued, self._futures = [], []
        replies = self._client.call_batch(calls, return_exceptions=True)
        for fut, reply in zip(futures, replies):
            if isinstance(reply, RpcError):
                fut._resolve({"ok": False, "error": str(reply)})
            else:
                fut._resolve({"ok": True, "result": reply})
        return futures

    def __enter__(self) -> "RpcPipeline":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.flush()
