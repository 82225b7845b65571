"""Replica wire protocol: length-framed numpy trees over unix sockets.

The fleet is co-located (replicas are processes on one host sharing a
model dir and a `FileKV`), so the transport is deliberately minimal:
a unix domain socket per replica, 4-byte big-endian length frames, and
a self-describing codec — a JSON header holding the tree structure
with array leaves replaced by `{"__ndarray__": index, shape, dtype}`
placeholders, followed by the arrays' raw bytes in index order. No
pickle (a replica must never execute a peer's bytes), no schema
registry, bit-exact round-trips for every float.

Request/response are plain dicts:

    {"op": "serve", "deadline_secs": 0.5, "features": <tree>}
    -> {"status": "ok", "generation": 3, "outputs": <tree>,
        "cascade_level": 0, "retry_after": null, "error": null}

plus `{"op": "stats"}` (the watermark snapshot) and `{"op": "drain"}`.

Host-only module: arrays pass through as host numpy; device placement
is the replica's batcher's business.
"""

from __future__ import annotations

import json
import logging
import os
import socket
import struct
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

_LOG = logging.getLogger("adanet_tpu_torch")

#: Frame and per-message hard caps (a corrupt length prefix must not
#: look like an instruction to allocate gigabytes).
MAX_MESSAGE_BYTES = 256 << 20

_LEN = struct.Struct(">I")


class TransportError(OSError):
    """Connection-level failure: peer dead, refused, or torn frame."""


# ----------------------------------------------------------------- codec


def encode_message(obj: Any) -> bytes:
    """Tree -> one frame payload (JSON header + raw array blobs)."""
    blobs: List[bytes] = []

    def visit(node):
        if isinstance(node, np.ndarray) or isinstance(
            node, np.generic
        ):
            # Record the shape BEFORE ascontiguousarray: it promotes
            # 0-d arrays/scalars to shape (1,), and a scalar leaf
            # arriving as (1,) is a different pytree structure that
            # fails the replica's exported-signature check.
            arr = np.asarray(node)
            if arr.dtype.kind not in "biufc":
                # Object/string/void arrays would serialize as raw
                # POINTER bytes and blow up the peer's decode (which
                # drops the connection and reads as a dead replica):
                # fail the bad sender here instead.
                raise TypeError(
                    "unsupported array dtype %r in fleet message"
                    % (arr.dtype,)
                )
            index = len(blobs)
            blobs.append(np.ascontiguousarray(arr).tobytes())
            return {
                "__ndarray__": index,
                "shape": list(arr.shape),
                "dtype": arr.dtype.str,
            }
        if isinstance(node, dict):
            for key in node:
                if not isinstance(key, str):
                    # Coercing int keys to "0" would hand the replica
                    # a structurally different pytree and turn a bad
                    # client into a server-side `error`: fail the
                    # sender instead, like the dtype check above.
                    raise TypeError(
                        "non-string dict key %r in fleet message"
                        % (key,)
                    )
            return {k: visit(v) for k, v in node.items()}
        if isinstance(node, tuple):
            return {"__tuple__": [visit(v) for v in node]}
        if isinstance(node, list):
            return [visit(v) for v in node]
        return node

    header = json.dumps(visit(obj)).encode()
    parts = [_LEN.pack(len(header)), header]
    parts.extend(blobs)
    return b"".join(parts)


def decode_message(payload: bytes) -> Any:
    if len(payload) < 4:
        # A torn/corrupt length prefix must land in the transport's
        # own exception taxonomy (the balancer retries TransportError;
        # a bare struct.error would escape it).
        raise TransportError(
            "truncated frame: %d bytes" % len(payload)
        )
    header_len = _LEN.unpack_from(payload)[0]
    header = json.loads(payload[4 : 4 + header_len].decode())
    offset = [4 + header_len]

    def visit(node):
        if isinstance(node, dict):
            if "__ndarray__" in node:
                dtype = np.dtype(node["dtype"])
                shape = tuple(int(d) for d in node["shape"])
                count = int(np.prod(shape, dtype=np.int64)) if shape else 1
                nbytes = count * dtype.itemsize
                lo = offset[0]
                offset[0] = lo + nbytes
                return np.frombuffer(
                    payload, dtype=dtype, count=count, offset=lo
                ).reshape(shape).copy()
            if "__tuple__" in node:
                return tuple(visit(v) for v in node["__tuple__"])
            return {k: visit(v) for k, v in node.items()}
        if isinstance(node, list):
            return [visit(v) for v in node]
        return node

    # Arrays are decoded in the same depth-first order they were
    # encoded, so one running offset reconstructs every blob. The
    # header stores indices for self-description; order equality is
    # guaranteed by using the same traversal on both sides.
    return visit(header)


# --------------------------------------------------------------- framing


def _read_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    while n:
        chunk = sock.recv(min(n, 1 << 20))
        if not chunk:
            raise TransportError("peer closed mid-frame")
        chunks.append(chunk)
        n -= len(chunk)
    return b"".join(chunks)


def send_frame(sock: socket.socket, message: Any) -> None:
    payload = encode_message(message)
    sock.sendall(_LEN.pack(len(payload)) + payload)


def recv_frame(sock: socket.socket) -> Any:
    size = _LEN.unpack(_read_exact(sock, 4))[0]
    if size > MAX_MESSAGE_BYTES:
        raise TransportError("frame of %d bytes exceeds the cap" % size)
    return decode_message(_read_exact(sock, size))


# ---------------------------------------------------------------- server


class SocketServer:
    """Threaded unix-socket server: one handler call per frame.

    `handler(message) -> message`; handler exceptions answer the frame
    with `{"status": "error"}` rather than killing the connection —
    the transport never converts a bug into a dropped request.
    """

    def __init__(self, path: str, handler: Callable[[Dict], Dict]):
        self.path = path
        self._handler = handler
        try:
            os.unlink(path)
        except OSError:
            pass
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.bind(path)
        self._sock.listen(64)
        self._stopped = threading.Event()
        self._threads: List[threading.Thread] = []
        self._conns: List[socket.socket] = []
        self._conns_lock = threading.Lock()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="fleet-accept", daemon=True
        )

    def start(self) -> "SocketServer":
        self._accept_thread.start()
        return self

    def _accept_loop(self) -> None:
        while not self._stopped.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            with self._conns_lock:
                self._conns = [
                    c for c in self._conns if c.fileno() >= 0
                ]
                self._conns.append(conn)
            thread = threading.Thread(
                target=self._serve_conn,
                args=(conn,),
                name="fleet-conn",
                daemon=True,
            )
            thread.start()
            # Prune finished connection threads so a long-lived replica
            # serving churning clients doesn't accumulate dead Thread
            # objects without bound.
            self._threads = [
                t for t in self._threads if t.is_alive()
            ]
            self._threads.append(thread)

    def _serve_conn(self, conn: socket.socket) -> None:
        with conn:
            while not self._stopped.is_set():
                try:
                    message = recv_frame(conn)
                except (
                    TransportError,
                    OSError,
                    ValueError,
                    struct.error,
                ):
                    return  # client went away / torn frame: drop conn
                try:
                    reply = self._handler(message)
                except Exception as exc:  # never kill the connection
                    _LOG.exception("Fleet handler failed.")
                    reply = {
                        "status": "error",
                        "error": "%s: %s" % (type(exc).__name__, exc),
                    }
                try:
                    send_frame(conn, reply)
                except OSError:
                    return

    def stop(self) -> None:
        self._stopped.set()
        try:
            self._sock.close()
        except OSError:
            pass
        # Close accepted connections too: a thread parked in
        # recv_frame would otherwise outlive the server and answer a
        # frame arriving AFTER stop on behalf of a drained replica.
        with self._conns_lock:
            conns, self._conns = self._conns, []
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass
        for thread in self._threads:
            thread.join(timeout=2.0)
        try:
            os.unlink(self.path)
        except OSError:
            pass


# ---------------------------------------------------------------- client


class SocketClient:
    """One replica's client: persistent connection, reconnect per send.

    Thread contract: NOT thread-safe — the balancer wraps one client
    per (thread, replica) or serializes sends itself.
    """

    def __init__(self, path: str, connect_timeout: float = 5.0):
        self.path = path
        self._timeout = connect_timeout
        self._sock: Optional[socket.socket] = None

    def _connect(self) -> socket.socket:
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.settimeout(self._timeout)
        sock.connect(self.path)
        return sock

    def send(
        self, message: Dict, timeout_secs: Optional[float] = None
    ) -> Dict:
        """One request/response round trip; raises TransportError."""
        try:
            if self._sock is None:
                self._sock = self._connect()
            self._sock.settimeout(
                timeout_secs if timeout_secs is not None else self._timeout
            )
            send_frame(self._sock, message)
            return recv_frame(self._sock)
        except (OSError, ValueError, struct.error) as exc:
            self.close()
            if isinstance(exc, TransportError):
                raise
            raise TransportError(
                "send to %s failed: %s: %s"
                % (self.path, type(exc).__name__, exc)
            ) from exc

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
