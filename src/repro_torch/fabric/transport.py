"""The fabric's ``Transport`` seam: loopback and framed sockets (the
port's twin of ``repro.fabric.transport``; the ``rpc.send``/``rpc.recv``
sites fire through :mod:`repro_torch.fault.seam`, so one ``FaultPlan``
JSON schedules the same network faults in both packages).

A transport carries :class:`~repro_torch.fabric.envelope.Envelope` requests to
one shard host and routes its replies back, correlated by ``msg_id``.
Two implementations share the contract:

  * :class:`LoopbackTransport` — in-process: envelopes are still
    **encoded and decoded** on every hop (so a type that cannot cross a
    real wire fails in unit tests, not in production) and still pass the
    ``rpc.send`` / ``rpc.recv`` fault seams (so a chaos schedule's
    network profile exercises the exact drop/duplicate/reorder handling
    the socket path uses, without sockets);
  * :class:`SocketTransport` — length-prefixed frames over TCP to a
    shard worker process (:func:`serve_socket` is the accept loop a
    worker runs).  One reader thread demultiplexes replies into the
    pending-future table.

Fault semantics (the ``network`` chaos profile): ``drop`` discards the
envelope — a request's future then times out and the CLIENT is
responsible for retry (appends carry sequence numbers, so a retried
write is deduplicated server-side; that is the zero-acked-loss
argument).  ``duplicate`` delivers twice; the host dedups appends and
the client counts surplus replies in ``stats()``.  ``reorder`` holds an
envelope until the next one passes.  ``stall`` sleeps inside the seam.

A dropped reply and a dropped request are indistinguishable to the
caller — both surface as :class:`ReplyTimeout` — which is exactly the
ambiguity real networks force, and why the append protocol is
idempotent rather than clever.
"""
from __future__ import annotations

import socket
import struct
import threading

from repro_torch.fabric import envelope as env_mod
from repro_torch.fabric.envelope import Envelope, WireError
from repro_torch.fault import seam

__all__ = ["ReplyFuture", "ReplyTimeout", "TransportClosed",
           "LoopbackTransport", "SocketTransport", "serve_socket"]


class ReplyTimeout(TimeoutError):
    """No reply within the deadline (request or reply may have been
    lost — the fabric cannot tell which)."""


class TransportClosed(RuntimeError):
    """Send on a closed/failed transport."""


class ReplyFuture:
    """One in-flight request's reply slot.  ``cancel()`` abandons it
    (hedged-read losers do this); a reply landing afterwards is counted
    by the transport as ``late`` instead of delivered."""

    __slots__ = ("msg_id", "_ev", "_env", "_err", "_cancelled", "_lock")

    def __init__(self, msg_id: int):
        self.msg_id = msg_id
        self._ev = threading.Event()
        self._env: Envelope | None = None
        self._err: BaseException | None = None
        self._cancelled = False
        self._lock = threading.Lock()

    def _resolve(self, env: Envelope) -> bool:
        """True if the reply was delivered (False: cancelled/dup)."""
        with self._lock:
            if self._cancelled or self._ev.is_set():
                return False
            self._env = env
        self._ev.set()
        return True

    def _reject(self, err: BaseException) -> bool:
        with self._lock:
            if self._cancelled or self._ev.is_set():
                return False
            self._err = err
        self._ev.set()
        return True

    def cancel(self) -> bool:
        """Abandon the request (True if it had not resolved yet)."""
        with self._lock:
            if self._ev.is_set():
                return False
            self._cancelled = True
        self._ev.set()
        return True

    @property
    def cancelled(self) -> bool:
        return self._cancelled

    def done(self) -> bool:
        return self._ev.is_set()

    def wait(self, timeout: float | None = None) -> bool:
        return self._ev.wait(timeout)

    def result(self, timeout: float | None = None) -> Envelope:
        if not self._ev.wait(timeout):
            raise ReplyTimeout(
                f"no reply to msg {self.msg_id} within {timeout}s")
        if self._cancelled:
            raise ReplyTimeout(f"request msg {self.msg_id} was cancelled")
        if self._err is not None:
            raise self._err
        return self._env


class _Gate:
    """Drop/duplicate/reorder state for one seam direction.  ``admit``
    maps one envelope to the list actually delivered now (a held
    envelope rides behind the next admitted one)."""

    __slots__ = ("site", "name", "_held", "_lock")

    def __init__(self, site: str, name: str):
        self.site = site
        self.name = name
        self._held: list = []
        self._lock = threading.Lock()

    def admit(self, item, *, kind: str, size: int) -> list:
        d = seam.fire(self.site, path=self.name, kind=kind, size=size)
        if d:
            if d.get("drop"):
                out = []
            elif d.get("duplicate"):
                out = [item, item]
            elif d.get("hold"):
                with self._lock:
                    self._held.append(item)
                return []
            else:
                out = [item]
        else:
            out = [item]
        with self._lock:
            if self._held:
                out = out + self._held
                self._held = []
        return out

    def flush(self) -> list:
        """Release anything still held (transport close: a held frame
        must not be silently lost forever)."""
        with self._lock:
            out, self._held = self._held, []
            return out


class _PendingTable:
    """msg_id -> ReplyFuture, with late/duplicate-reply accounting."""

    def __init__(self):
        self._lock = threading.Lock()
        self._pending: dict[int, ReplyFuture] = {}
        self._ids = 0
        self.late_replies = 0          # replies for cancelled/unknown ids

    def new(self) -> ReplyFuture:
        with self._lock:
            self._ids += 1
            fut = ReplyFuture(self._ids)
            self._pending[fut.msg_id] = fut
        return fut

    def resolve(self, env: Envelope) -> None:
        with self._lock:
            fut = self._pending.pop(env.msg_id, None)
        if fut is None or not fut._resolve(env):
            with self._lock:
                self.late_replies += 1

    def fail_all(self, err: BaseException) -> None:
        with self._lock:
            futs = list(self._pending.values())
            self._pending.clear()
        for fut in futs:
            fut._reject(err)

    def forget(self, fut: ReplyFuture) -> None:
        with self._lock:
            self._pending.pop(fut.msg_id, None)

    def __len__(self) -> int:
        with self._lock:
            return len(self._pending)


class LoopbackTransport:
    """In-process transport over a :class:`repro_torch.fabric.protocol.
    ServiceHost` (see module docstring for why it still encodes and
    still fires the rpc seams)."""

    def __init__(self, host, *, name: str = "loopback"):
        self._host = host
        self.name = name
        self._pending = _PendingTable()
        self._send_gate = _Gate("rpc.send", name)
        self._recv_gate = _Gate("rpc.recv", name)
        self._closed = False

    # one logical wire, same seam sites as the socket path: requests
    # fire ``rpc.send`` on the way out, replies fire ``rpc.recv`` on the
    # way back — one faulty hop per direction, so a chaos schedule's
    # occurrence numbering is identical between loopback and socket
    # runs, and a held (reordered) frame can only ever be released by
    # traffic of its OWN direction
    def send(self, env: Envelope) -> ReplyFuture:
        if self._closed:
            raise TransportClosed(f"loopback {self.name} is closed")
        fut = self._pending.new()
        env = Envelope(env.kind, msg_id=fut.msg_id, trace=env.trace,
                       payload=env.payload)
        frame = env_mod.encode(env)
        for f in self._send_gate.admit(frame, kind=env.kind,
                                       size=len(frame)):
            self._host.handle(env_mod.decode(f), self._on_reply)
        return fut

    def _on_reply(self, reply: Envelope) -> None:
        # a dropped/held ack is the interesting case for exactly-once
        # appends: the request applied, the client cannot know
        frame = env_mod.encode(reply)
        for f in self._recv_gate.admit(frame, kind=reply.kind,
                                       size=len(frame)):
            self._pending.resolve(env_mod.decode(f))

    def request(self, env: Envelope, timeout: float | None = None
                ) -> Envelope:
        fut = self.send(env)
        try:
            return fut.result(timeout)
        finally:
            self._pending.forget(fut)

    def stats(self) -> dict:
        return {"name": self.name, "kind": "loopback",
                "pending": len(self._pending),
                "late_replies": self._pending.late_replies}

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        # release reordered holds in-direction (held requests reach the
        # host, held replies reach their futures), then fail the rest
        for f in self._send_gate.flush():
            self._host.handle(env_mod.decode(f), self._on_reply)
        for f in self._recv_gate.flush():
            self._pending.resolve(env_mod.decode(f))
        self._pending.fail_all(TransportClosed(
            f"loopback {self.name} closed"))


_LEN = struct.Struct("<I")


def _read_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed mid-frame"
                                  if buf else "peer closed")
        buf += chunk
    return bytes(buf)


def _write_frame(sock: socket.socket, frame: bytes,
                 lock: threading.Lock) -> None:
    with lock:
        sock.sendall(_LEN.pack(len(frame)) + frame)


def _read_frame(sock: socket.socket) -> bytes:
    (n,) = _LEN.unpack(_read_exact(sock, _LEN.size))
    return _read_exact(sock, n)


class SocketTransport:
    """Framed-TCP client to one shard worker.  Thread-safe: any thread
    may ``send``; one reader thread resolves replies."""

    def __init__(self, address: tuple[str, int], *,
                 name: str | None = None, connect_timeout: float = 10.0):
        self.address = address
        self.name = name or f"{address[0]}:{address[1]}"
        self._sock = socket.create_connection(address,
                                              timeout=connect_timeout)
        self._sock.settimeout(None)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._wlock = threading.Lock()
        self._pending = _PendingTable()
        self._send_gate = _Gate("rpc.send", self.name)
        self._recv_gate = _Gate("rpc.recv", self.name)
        self._closed = False
        self._reader = threading.Thread(
            target=self._read_loop, name=f"fabric-reader-{self.name}",
            daemon=True)
        self._reader.start()

    def send(self, env: Envelope) -> ReplyFuture:
        if self._closed:
            raise TransportClosed(f"socket {self.name} is closed")
        fut = self._pending.new()
        env = Envelope(env.kind, msg_id=fut.msg_id, trace=env.trace,
                       payload=env.payload)
        frame = env_mod.encode(env)
        try:
            for f in self._send_gate.admit(frame, kind=env.kind,
                                           size=len(frame)):
                _write_frame(self._sock, f, self._wlock)
        except OSError as e:
            self._pending.forget(fut)
            raise TransportClosed(f"socket {self.name}: {e}") from e
        return fut

    def request(self, env: Envelope, timeout: float | None = None
                ) -> Envelope:
        fut = self.send(env)
        try:
            return fut.result(timeout)
        finally:
            self._pending.forget(fut)

    def _read_loop(self) -> None:
        try:
            while True:
                frame = _read_frame(self._sock)
                env = env_mod.decode(frame)
                for f in self._recv_gate.admit(frame, kind=env.kind,
                                               size=len(frame)):
                    self._pending.resolve(env_mod.decode(f))
        except (OSError, ConnectionError, WireError) as e:
            for f in self._recv_gate.flush():
                self._pending.resolve(env_mod.decode(f))
            if not self._closed:
                self._pending.fail_all(TransportClosed(
                    f"socket {self.name} reader died: {e}"))

    def stats(self) -> dict:
        return {"name": self.name, "kind": "socket",
                "address": list(self.address),
                "pending": len(self._pending),
                "late_replies": self._pending.late_replies}

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()
        self._pending.fail_all(TransportClosed(
            f"socket {self.name} closed"))


class serve_socket:
    """The worker-side accept loop: every connection gets a reader
    thread that feeds decoded envelopes to ``host.handle`` and writes
    its (possibly later) replies back under a per-connection lock.

    Class-as-function naming: instances are single-use servers —
    ``serve_socket(host, port=0)`` starts listening immediately;
    ``.port`` is the bound port, ``.close()`` stops.  The server side
    deliberately fires NO rpc seams: one faulty hop per direction
    (client-side send + recv) keeps a chaos schedule's occurrence
    numbering identical between loopback and socket runs.
    """

    def __init__(self, host, *, address: str = "127.0.0.1",
                 port: int = 0, backlog: int = 64):
        self._host = host
        self._lsock = socket.create_server((address, port),
                                           backlog=backlog)
        self.address = self._lsock.getsockname()
        self.port = self.address[1]
        self._closed = False
        self._conns: list[socket.socket] = []
        self._lock = threading.Lock()
        self._accept = threading.Thread(
            target=self._accept_loop, name=f"fabric-accept-{self.port}",
            daemon=True)
        self._accept.start()

    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                conn, _ = self._lsock.accept()
            except OSError:
                return                      # listener closed
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._lock:
                if self._closed:
                    conn.close()
                    return
                self._conns.append(conn)
            threading.Thread(target=self._conn_loop, args=(conn,),
                             name=f"fabric-conn-{self.port}",
                             daemon=True).start()

    def _conn_loop(self, conn: socket.socket) -> None:
        wlock = threading.Lock()

        def reply(env: Envelope) -> None:
            try:
                _write_frame(conn, env_mod.encode(env), wlock)
            except OSError:
                pass                        # client gone; reply moot

        try:
            while True:
                env = env_mod.decode(_read_frame(conn))
                self._host.handle(env, reply)
        except (OSError, ConnectionError, WireError):
            pass
        finally:
            conn.close()
            with self._lock:
                if conn in self._conns:
                    self._conns.remove(conn)

    def close(self) -> None:
        self._closed = True
        try:
            self._lsock.close()
        except OSError:
            pass
        with self._lock:
            conns, self._conns = list(self._conns), []
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            c.close()
