"""Length-prefixed JSON-frame RPC over TCP — the control plane's wire.

The job service's verbs (submit/pause/resume/cancel/status/...) are
plain JSON dicts; this module moves them across a process boundary with
the smallest honest transport: each message is one *frame* — a 4-byte
big-endian unsigned length followed by that many bytes of UTF-8 JSON.
Stdlib only (``socketserver`` + ``struct`` + ``json``), no HTTP stack,
because the paper's control plane is request/response over a broker and
the interesting properties live above the wire: the server serializes
every dispatch under one lock (the job server's verbs are not
internally thread-safe), and the client owns timeouts and bounded
reconnect-retries — delivery is therefore at-least-once, which the
verbs tolerate (submit of a live job errors loudly; pause/resume/
cancel/status are idempotent).
"""

from __future__ import annotations

import json
import socket
import socketserver
import struct
import threading
import time
from typing import Any, Callable

__all__ = [
    "MAX_FRAME_BYTES",
    "FrameClient",
    "FrameServer",
    "RPCError",
    "recv_frame",
    "send_frame",
]

# One control-plane message should be small (verbs + status dicts); the
# cap exists so a corrupt length header can't allocate gigabytes.
MAX_FRAME_BYTES = 16 * 1024 * 1024

_HEADER = struct.Struct(">I")


class RPCError(RuntimeError):
    """A control-plane call failed — transport exhausted its retries, a
    frame was malformed/oversized, or the server answered ``ok: False``
    (in which case the message carries the server-side exception text)."""


def send_frame(sock: socket.socket, obj: Any) -> None:
    """Serialize ``obj`` as one length-prefixed JSON frame onto ``sock``.
    Raises ``ValueError`` if the payload exceeds ``MAX_FRAME_BYTES`` and
    ``TypeError`` if ``obj`` is not JSON-serializable — both before any
    bytes hit the wire, so a failed send never corrupts the stream."""
    payload = json.dumps(obj, separators=(",", ":")).encode("utf-8")
    if len(payload) > MAX_FRAME_BYTES:
        raise ValueError(f"frame of {len(payload)} bytes exceeds "
                         f"MAX_FRAME_BYTES={MAX_FRAME_BYTES}")
    sock.sendall(_HEADER.pack(len(payload)) + payload)


def recv_frame(sock: socket.socket) -> Any:
    """Read one frame from ``sock`` and decode its JSON body.  Returns
    ``None`` on an orderly EOF *between* frames (peer hung up cleanly);
    raises ``ConnectionError`` on EOF mid-frame and ``RPCError`` on an
    oversized length header."""
    header = _recv_exact(sock, _HEADER.size, eof_ok=True)
    if header is None:
        return None
    (length,) = _HEADER.unpack(header)
    if length > MAX_FRAME_BYTES:
        raise RPCError(f"incoming frame claims {length} bytes "
                       f"(> MAX_FRAME_BYTES={MAX_FRAME_BYTES})")
    return json.loads(_recv_exact(sock, length).decode("utf-8"))


def _recv_exact(sock: socket.socket, n: int,
                eof_ok: bool = False) -> bytes | None:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            if eof_ok and not buf:
                return None
            raise ConnectionError(
                f"connection closed mid-frame ({len(buf)}/{n} bytes)")
        buf += chunk
    return bytes(buf)


class FrameServer:
    """Serve a ``handle(dict) -> dict`` callable over frame RPC.

    A ``ThreadingTCPServer`` accepts any number of concurrent clients
    (daemon threads, one frame loop per connection), but every dispatch
    into ``handle`` runs under ONE lock — clients get concurrency on the
    wire, the handler gets the single-threaded world it was written for.
    ``port=0`` binds an ephemeral port; read it back from ``address``.
    """

    def __init__(self, handle: Callable[[dict], dict],
                 host: str = "127.0.0.1", port: int = 0) -> None:
        self._handle = handle
        self._lock = threading.RLock()
        self._thread: threading.Thread | None = None
        outer = self

        class _Handler(socketserver.BaseRequestHandler):
            def handle(self) -> None:
                while True:
                    try:
                        request = recv_frame(self.request)
                    except (ConnectionError, OSError, RPCError,
                            json.JSONDecodeError):
                        return
                    if request is None:
                        return
                    with outer._lock:
                        response = outer._dispatch(request)
                    try:
                        send_frame(self.request, response)
                    except OSError:
                        return

        class _Server(socketserver.ThreadingTCPServer):
            daemon_threads = True
            allow_reuse_address = True

        self._server = _Server((host, port), _Handler)

    def _dispatch(self, request: dict) -> dict:
        try:
            response = self._handle(request)
            # force serializability server-side so the error surfaces in
            # the reply instead of tearing down the connection
            json.dumps(response)
            return response
        except Exception as exc:  # noqa: BLE001 — the wire reports, not raises
            return {"ok": False, "error": f"{type(exc).__name__}: {exc}"}

    @property
    def address(self) -> tuple[str, int]:
        """The bound ``(host, port)`` — what a ``FrameClient`` dials."""
        host, port = self._server.server_address[:2]
        return (host, port)

    def start(self) -> "FrameServer":
        """Begin serving on a daemon thread; returns ``self`` so
        ``server = FrameServer(h).start()`` reads naturally."""
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            kwargs={"poll_interval": 0.05},
            name=f"frame-server:{self.address[1]}", daemon=True)
        self._thread.start()
        return self

    def close(self) -> None:
        """Stop accepting, close the listening socket, join the serve
        thread.  Idempotent."""
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def __enter__(self) -> "FrameServer":
        return self.start()

    def __exit__(self, *exc: Any) -> None:
        self.close()


class FrameClient:
    """Dial a :class:`FrameServer` and exchange one frame per call.

    The connection is lazy and persistent; ``timeout`` bounds every
    socket operation and ``retries`` bounds reconnect-and-resend
    attempts on transport failure (connection refused, timeout, peer
    reset), with linear backoff between attempts.  Resending after a
    sent-but-unanswered request makes delivery at-least-once — fine for
    this control plane, whose verbs are idempotent or loudly duplicate-
    rejecting.  When every attempt fails, raises :class:`RPCError`
    carrying the last transport error.
    """

    def __init__(self, address: tuple[str, int], *, timeout: float = 5.0,
                 retries: int = 2, retry_delay: float = 0.05) -> None:
        self.address = (address[0], int(address[1]))
        self.timeout = timeout
        self.retries = max(0, int(retries))
        self.retry_delay = retry_delay
        self._sock: socket.socket | None = None

    def _connect(self) -> socket.socket:
        if self._sock is None:
            self._sock = socket.create_connection(self.address,
                                                  timeout=self.timeout)
            self._sock.settimeout(self.timeout)
        return self._sock

    def call(self, request: dict) -> dict:
        """One request frame out, one response frame back."""
        last: Exception | None = None
        for attempt in range(self.retries + 1):
            try:
                sock = self._connect()
                send_frame(sock, request)
                response = recv_frame(sock)
                if response is None:
                    raise ConnectionError("server closed the connection")
                return response
            except (OSError, ConnectionError) as exc:
                last = exc
                self.close()
                if attempt < self.retries:
                    time.sleep(self.retry_delay * (attempt + 1))
        raise RPCError(f"rpc to {self.address[0]}:{self.address[1]} failed "
                       f"after {self.retries + 1} attempt(s): {last}")

    def close(self) -> None:
        """Drop the persistent connection (the next ``call`` redials).
        Idempotent."""
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def __enter__(self) -> "FrameClient":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()
