"""Length-prefixed socket RPC framing for the cross-process LUT fleet
(the port's own copy of ``repro.launch.transport``: the same frames and
payloads, byte for byte, so what either package packs the other
decodes).

The fleet promotes replicas from threads-in-one-address-space to real
worker processes (the distributed-llama idiom: commodity workers behind a
root node).  This module is the wire layer shared by the root
(``launch/fleet.py``) and the workers (``launch/worker.py``).  It carries
no model logic — only framing, request multiplexing, and typed errors.

Frame layout
------------

Every message on the wire is one frame::

    +--------+----------------+---------------------+
    | type   | req_id         | payload_len         |
    | u8     | u32 big-endian | u32 big-endian      |
    +--------+----------------+---------------------+
    | payload (payload_len bytes)                    |
    +------------------------------------------------+

i.e. a 9-byte ``!BII`` header followed by the payload.  The payload is
itself split into a JSON metadata dict and an optional raw binary blob::

    +----------------+---------------------+------------------+
    | meta_len (u32) | meta (JSON, UTF-8)  | blob (remainder) |
    +----------------+---------------------+------------------+

Small control messages ship an empty blob; request rows, result rows and
artifact slab chunks ride in the blob so numeric data never round-trips
through JSON.

Request ids and pipelining
--------------------------

``req_id`` is allocated by the sender of a request frame and echoed by
every frame answering it, so many requests can be in flight on one
connection at once (the root pipelines ``SUBMIT`` frames without waiting
for earlier results).  Odd/even spaces are not reserved: in this
protocol only the root originates requests; workers only ever echo.

A request is normally answered by exactly one ``OK`` or ``ERR`` frame.
The exception is ``SUBMIT``, which is answered twice: an immediate ``OK``
(admission ack — the request was accepted by the worker's registry) or
``ERR`` (typed rejection, e.g. unknown model or deadline unmeetable),
then later an asynchronous ``RESULT`` frame carrying the computed row
once the worker's microbatcher flushes.  ``RESULT`` reuses the
``SUBMIT``'s req_id.

Message types
-------------

======================  =====================================================
type                    semantics
======================  =====================================================
``HELLO``               root → worker once per connection; meta carries the
                        registry config (microbatch, deadline_s, slo tiers,
                        work_stealing, device, store dir).  Worker
                        answers ``OK`` with ``{"pid": ..., "epoch": 0}``.
``PING``                liveness probe; worker answers ``OK`` with current
                        ``{"outstanding": ..., "delay_est": {model: s}}`` so
                        the root's router can rank replicas without a
                        blocking RPC inside its lock.  A port worker adds
                        ``"launches"``, its process's kernel launch counts
                        (zeroed first when the PING's meta says
                        ``{"reset_launches": true}``); a reference root
                        ignores the key.
``SUBMIT``              meta ``{model_id, tier?, shape, dtype}``, blob = row
                        bytes.  Acked, then answered by ``RESULT``.
``RESULT``              worker → root; meta ``{ok, tag, flush_key, shape,
                        dtype}`` (or ``{ok: false, kind, error}``), blob =
                        result row bytes.
``FETCH_BEGIN``         start streaming an artifact into the worker's store;
                        meta ``{artifact: basename, files: [...]}``.
``FETCH_CHUNK``         meta ``{file, seq}``, blob = chunk bytes.
``FETCH_END``           all chunks sent; worker assembles the files,
                        re-hashes every slab via ``verify_artifact`` and
                        answers ``OK {artifact_id, path}`` or a typed
                        ``ERR kind="artifact"`` so the root can re-fetch.
``REGISTER``            register a model version from a fetched artifact.
``PREPARE``             two-phase swap phase 1: load + warm off to the side;
                        answers ``OK {entry_id, version_tag, warm_s}``.
``COMMIT``              two-phase swap phase 2 for a prepared ``entry_id``;
                        answers with the serialized ``SwapReport``.
``ABANDON``             discard a prepared ``entry_id`` (best-effort).
``SWAP``                one-shot prepare+commit (non-fleet convenience).
``MODEL_IDS``           list the worker registry's model ids.
``LEAVE``               graceful membership departure; worker acks then
                        closes.  Anything else on a closed/severed
                        connection surfaces as ``ConnectionClosed``.
``OK`` / ``ERR``        responses; ``ERR`` meta is ``{kind, error}`` where
                        ``kind`` is a stable string the client maps back to
                        a typed exception (``unknown_model``,
                        ``deadline_unmeetable``, ``artifact``, ``internal``).
======================  =====================================================

Epoch semantics
---------------

Fleet membership is versioned by a monotonically increasing **epoch**
counter owned by the root.  Every join (worker spawned and HELLO'd) and
every leave — graceful ``LEAVE``, heartbeat declared death, or explicit
kill — bumps the epoch.  The epoch is not a wire field on data frames;
it names membership snapshots on the root (``LutFleet.membership()``)
so tests and operators can assert "the fleet saw exactly N membership
changes" and routing decisions can be attributed to a membership view.
Workers learn their join epoch in the HELLO ack but never gossip:
membership is root-owned, matching the single-root topology.

Liveness is probed with ``PING`` frames on a fixed cadence; a worker
that misses ``heartbeat_miss_limit`` consecutive probes is declared dead
(epoch bump, marked unhealthy, in-flight requests failed over by
``FleetHandle`` re-dispatch).  A worker that answers again after being
declared dead is NOT resurrected automatically — rejoin is a new spawn.
"""

from __future__ import annotations

import json
import socket
import struct
import threading
from typing import Any, Callable, Dict, Optional, Tuple

# ---------------------------------------------------------------------------
# Frame constants
# ---------------------------------------------------------------------------

HEADER = struct.Struct("!BII")  # msg type, req id, payload length
META_LEN = struct.Struct("!I")

#: Hard cap on a single frame payload (64 MiB) — a corrupted length
#: prefix must not make the receiver attempt a huge allocation.
MAX_PAYLOAD = 64 * 1024 * 1024

#: Chunk size for streaming slab transfer.
FETCH_CHUNK_BYTES = 256 * 1024

MSG_HELLO = 1
MSG_PING = 2
MSG_SUBMIT = 3
MSG_RESULT = 4
MSG_FETCH_BEGIN = 5
MSG_FETCH_CHUNK = 6
MSG_FETCH_END = 7
MSG_REGISTER = 8
MSG_SWAP = 9
MSG_PREPARE = 10
MSG_COMMIT = 11
MSG_ABANDON = 12
MSG_MODEL_IDS = 13
MSG_LEAVE = 14
MSG_OK = 15
MSG_ERR = 16

MSG_NAMES = {
    MSG_HELLO: "HELLO",
    MSG_PING: "PING",
    MSG_SUBMIT: "SUBMIT",
    MSG_RESULT: "RESULT",
    MSG_FETCH_BEGIN: "FETCH_BEGIN",
    MSG_FETCH_CHUNK: "FETCH_CHUNK",
    MSG_FETCH_END: "FETCH_END",
    MSG_REGISTER: "REGISTER",
    MSG_SWAP: "SWAP",
    MSG_PREPARE: "PREPARE",
    MSG_COMMIT: "COMMIT",
    MSG_ABANDON: "ABANDON",
    MSG_MODEL_IDS: "MODEL_IDS",
    MSG_LEAVE: "LEAVE",
    MSG_OK: "OK",
    MSG_ERR: "ERR",
}


class TransportError(RuntimeError):
    """Framing-level failure (oversized frame, short read, bad header)."""


class ConnectionClosed(TransportError):
    """The peer went away (EOF, reset, or local close)."""


class RpcError(RuntimeError):
    """Typed application error returned by the peer in an ``ERR`` frame."""

    def __init__(self, kind: str, message: str):
        super().__init__(message)
        self.kind = kind


# ---------------------------------------------------------------------------
# Payload packing
# ---------------------------------------------------------------------------


def pack_payload(meta: Dict[str, Any], blob: bytes = b"") -> bytes:
    raw = json.dumps(meta, separators=(",", ":")).encode("utf-8")
    return META_LEN.pack(len(raw)) + raw + blob


def unpack_payload(payload: bytes) -> Tuple[Dict[str, Any], bytes]:
    if len(payload) < META_LEN.size:
        raise TransportError("payload shorter than meta length prefix")
    (mlen,) = META_LEN.unpack_from(payload, 0)
    end = META_LEN.size + mlen
    if end > len(payload):
        raise TransportError("meta length prefix exceeds payload")
    meta = json.loads(payload[META_LEN.size : end].decode("utf-8"))
    return meta, payload[end:]


# ---------------------------------------------------------------------------
# Framed connection
# ---------------------------------------------------------------------------


class FrameConn:
    """A framed, thread-safe-for-send socket connection.

    ``send`` may be called from many threads (serialized by a lock);
    ``recv`` must be called from exactly one reader thread.
    """

    def __init__(self, sock: socket.socket):
        self._sock = sock
        self._send_lock = threading.Lock()
        self._rfile = sock.makefile("rb")
        self._closed = False

    def send(self, msg_type: int, req_id: int, meta: Dict[str, Any], blob: bytes = b"") -> None:
        payload = pack_payload(meta, blob)
        if len(payload) > MAX_PAYLOAD:
            raise TransportError(f"frame payload {len(payload)}B exceeds cap {MAX_PAYLOAD}B")
        frame = HEADER.pack(msg_type, req_id, len(payload)) + payload
        with self._send_lock:
            if self._closed:
                raise ConnectionClosed("send on closed connection")
            try:
                self._sock.sendall(frame)
            except OSError as e:
                raise ConnectionClosed(f"send failed: {e}") from e

    def recv(self) -> Tuple[int, int, Dict[str, Any], bytes]:
        """Read one frame; returns ``(msg_type, req_id, meta, blob)``."""
        head = self._read_exact(HEADER.size)
        msg_type, req_id, plen = HEADER.unpack(head)
        if plen > MAX_PAYLOAD:
            raise TransportError(f"incoming payload {plen}B exceeds cap {MAX_PAYLOAD}B")
        meta, blob = unpack_payload(self._read_exact(plen))
        return msg_type, req_id, meta, blob

    def _read_exact(self, n: int) -> bytes:
        if self._closed:
            raise ConnectionClosed("recv on closed connection")
        try:
            buf = self._rfile.read(n)
        except OSError as e:
            raise ConnectionClosed(f"recv failed: {e}") from e
        if buf is None or len(buf) < n:
            raise ConnectionClosed("peer closed connection")
        return buf

    def close(self) -> None:
        self._closed = True
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._rfile.close()
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass


# ---------------------------------------------------------------------------
# Root-side RPC client
# ---------------------------------------------------------------------------


class RpcClient:
    """Pipelined request/response client over one :class:`FrameConn`.

    A background reader thread demultiplexes incoming frames by req_id:
    ``OK``/``ERR`` complete the pending call registered for that id,
    while ``RESULT`` frames are delivered to the handler registered by
    :meth:`expect_result` (the async second answer to a ``SUBMIT``).
    When the connection dies every pending call and result handler is
    failed with :class:`ConnectionClosed` and ``on_dead`` fires once.
    """

    def __init__(self, sock: socket.socket, *, on_dead: Optional[Callable[[Exception], None]] = None):
        self.conn = FrameConn(sock)
        self._on_dead = on_dead
        self._lock = threading.Lock()
        self._next_id = 1
        self._pending: Dict[int, "_PendingCall"] = {}
        self._result_handlers: Dict[int, Callable[[Dict[str, Any], bytes, Optional[Exception]], None]] = {}
        self._dead: Optional[Exception] = None
        self._reader = threading.Thread(target=self._read_loop, daemon=True, name="rpc-reader")
        self._reader.start()

    # -- id + registration ---------------------------------------------------

    def new_req_id(self) -> int:
        with self._lock:
            rid = self._next_id
            self._next_id += 1
            return rid

    def expect_result(self, req_id: int, handler: Callable[[Dict[str, Any], bytes, Optional[Exception]], None]) -> None:
        with self._lock:
            if self._dead is not None:
                dead = self._dead
            else:
                self._result_handlers[req_id] = handler
                return
        handler({}, b"", dead)

    # -- calls ---------------------------------------------------------------

    def call(
        self,
        msg_type: int,
        meta: Dict[str, Any],
        blob: bytes = b"",
        *,
        timeout: Optional[float] = 30.0,
        req_id: Optional[int] = None,
    ) -> Tuple[Dict[str, Any], bytes]:
        """Send a request frame and wait for its ``OK``/``ERR`` answer."""
        rid = self.new_req_id() if req_id is None else req_id
        pend = _PendingCall()
        with self._lock:
            if self._dead is not None:
                raise ConnectionClosed(str(self._dead))
            self._pending[rid] = pend
        try:
            self.conn.send(msg_type, rid, meta, blob)
        except TransportError:
            with self._lock:
                self._pending.pop(rid, None)
            raise
        if not pend.event.wait(timeout):
            with self._lock:
                self._pending.pop(rid, None)
            raise TransportError(
                f"timeout waiting for reply to {MSG_NAMES.get(msg_type, msg_type)} (req {rid})"
            )
        if pend.exc is not None:
            raise pend.exc
        return pend.meta, pend.blob

    def send_oneway(self, msg_type: int, req_id: int, meta: Dict[str, Any], blob: bytes = b"") -> None:
        self.conn.send(msg_type, req_id, meta, blob)

    # -- reader --------------------------------------------------------------

    def _read_loop(self) -> None:
        try:
            while True:
                msg_type, rid, meta, blob = self.conn.recv()
                if msg_type == MSG_RESULT:
                    with self._lock:
                        handler = self._result_handlers.pop(rid, None)
                    if handler is not None:
                        handler(meta, blob, None)
                    continue
                with self._lock:
                    pend = self._pending.pop(rid, None)
                if pend is None:
                    continue  # timed-out call's late answer
                if msg_type == MSG_ERR:
                    pend.exc = RpcError(meta.get("kind", "internal"), meta.get("error", "remote error"))
                else:
                    pend.meta, pend.blob = meta, blob
                pend.event.set()
        except TransportError as e:
            self._fail_all(e)
        except Exception as e:  # pragma: no cover - defensive
            self._fail_all(TransportError(f"reader crashed: {e}"))

    def _fail_all(self, exc: Exception) -> None:
        with self._lock:
            if self._dead is not None:
                return
            self._dead = exc
            pending = list(self._pending.values())
            self._pending.clear()
            handlers = list(self._result_handlers.values())
            self._result_handlers.clear()
        for p in pending:
            p.exc = ConnectionClosed(str(exc))
            p.event.set()
        for h in handlers:
            h({}, b"", ConnectionClosed(str(exc)))
        if self._on_dead is not None:
            try:
                self._on_dead(exc)
            except Exception:
                pass

    @property
    def dead(self) -> Optional[Exception]:
        return self._dead

    def close(self) -> None:
        self.conn.close()
        # reader thread notices EOF and fails pending calls


class _PendingCall:
    __slots__ = ("event", "meta", "blob", "exc")

    def __init__(self):
        self.event = threading.Event()
        self.meta: Dict[str, Any] = {}
        self.blob = b""
        self.exc: Optional[Exception] = None


# ---------------------------------------------------------------------------
# ndarray <-> blob helpers (dtype/shape ride in frame meta)
# ---------------------------------------------------------------------------


def array_meta(x) -> Dict[str, Any]:
    import numpy as np

    arr = np.asarray(x)
    return {"shape": list(arr.shape), "dtype": str(arr.dtype)}


def array_blob(x) -> bytes:
    import numpy as np

    return np.ascontiguousarray(np.asarray(x)).tobytes()


def blob_array(meta: Dict[str, Any], blob: bytes):
    import numpy as np

    return np.frombuffer(blob, dtype=np.dtype(meta["dtype"])).reshape(meta["shape"]).copy()
