"""TCP transport: the real two-plane network backend.

Re-design of the reference's ``TcpTransport``
(``distributor/transport.go:28-491``) with cleaner framing:

- **Control plane**: length-prefixed JSON envelopes (4-byte big-endian size
  + ``{"type", "src", "payload"}``) on persistent per-peer connections with
  a per-connection write lock (the reference instead streams back-to-back
  JSON objects, transport.go:100-124).
- **Data plane**: a ``LayerMsg`` travels as an envelope whose payload is the
  ``LayerHeader``, followed by exactly ``layer_size`` raw bytes — on a
  per-destination POOLED data connection: sequential transfers (a flow
  job's 16 MiB fragments) share one connection instead of paying a
  handshake + slow-start per fragment, while concurrent transfers still
  fan out over as many connections as are in flight.  (The reference dials
  fresh per transfer, transport.go:267-274 — fine for whole-layer sends,
  ~640 dials for a fragmented 10 GiB flow job.)
- In-memory layers are paced by a token bucket (transport.go:407-424); disk
  layers go out via ``socket.sendfile`` — the zero-copy path matching the
  reference's ``io.Copy(SectionReader)`` sendfile (transport.go:357-367).
- A registered ``(layer_id → dest_id)`` pipe relays an incoming layer to a
  downstream node *while* it is being received, chunk by chunk — cut-through
  relay, the reference's TeeReader trick (transport.go:144-196).
- Self-sends short-circuit into the local delivery queue
  (transport.go:282-285).
"""

from __future__ import annotations

import itertools
import json
import os
import queue
import selectors
import socket
import struct
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..core.types import LayerID, LayerLocation, LayerMeta, LayerSrc, NodeID
from ..ops.reassembly import stripe_offsets
from ..utils import integrity, telemetry, threads, trace
from ..utils.backoff import Backoff
from ..utils.buffers import alloc_recv_buffer
from ..utils.logging import log
from ..utils.rate import PacedWriter
from .base import AddrRegistry, Transport
from .messages import (
    LayerHeader,
    LayerMsg,
    Message,
    MsgType,
    decode_msg,
)

_LEN = struct.Struct("!I")
_CHUNK = 1 << 20  # 1 MiB receive/relay chunk
# Dial retry window: the reference has no retries at all (errors are only
# logged, node.go:345-348), so peers racing the leader's listener die.
_DIAL_TIMEOUT = 10.0
_DIAL_RETRY_DELAY = 0.1
# Pooled send retries (utils/backoff.py): how many FRESH dials a failed
# layer/control send gets — with jittered exponential delays between
# them — before the OSError surfaces to the protocol layer.  Matters
# during a failover window: every worker loses the leader at once, and
# un-jittered immediate retries would stampede the successor in
# lockstep.
_SEND_RETRIES = max(1, int(os.environ.get("DLD_TCP_SEND_RETRIES", "3")))

# --- layer striping -------------------------------------------------------
# One (source, layer) transfer used to ride ONE pooled data connection: a
# physical-size layer was a single serial byte stream, so end-to-end ingest
# was capped by per-socket throughput while the link (and the device side)
# could absorb multiples of it.  Payloads >= STRIPE_THRESHOLD split into up
# to STRIPE_COUNT stripes sent CONCURRENTLY over that many pooled data
# connections; each stripe is a well-formed byte-range fragment at its
# absolute offset (wire-compatible — see LayerHeader.stripe_*), so a
# receiver reassembles striped and un-striped frames through one path.
# STRIPE_MIN keeps every stripe big enough that TCP slow-start and framing
# overhead stay noise.  Rate-limited sends never stripe (N paced streams
# would multiply the commanded rate).
STRIPE_THRESHOLD = int(os.environ.get("DLD_TCP_STRIPE_THRESHOLD",
                                      str(8 << 20)))
STRIPE_COUNT = max(1, int(os.environ.get("DLD_TCP_STRIPES", "4")))
STRIPE_MIN = 2 << 20
# Rate-limited sends stripe only when the commanded rate is at least this
# (1 GB/s): past it the rate is a capacity BUDGET (an ICI/NIC line rate
# the flow solver allotted — the physical-size rows), which stripes split
# proportionally so the aggregate still honors it.  Below it the rate is
# a scarcity model (a slow source being simulated) whose burst semantics
# tests and the codec A/B rows depend on — those never stripe.
STRIPE_PACED_MIN_RATE = int(os.environ.get("DLD_TCP_STRIPE_MIN_RATE",
                                           str(10 ** 9)))
# Reassembly groups for striped transfers to a receiver WITHOUT a
# zero-copy layer sink are pruned after this long without completing
# (their sender died mid-transfer and gave up on the retry).
_STRIPE_GROUP_TTL = 300.0


def _dial(addr: Tuple[str, int], closed: threading.Event) -> socket.socket:
    """create_connection with jittered exponential retry until
    _DIAL_TIMEOUT elapses (utils/backoff.py): a dead peer costs a
    bounded, decaying probe sequence — not a tight 5 Hz loop — and
    concurrent dialers racing a restarting listener don't stampede it
    in lockstep."""
    deadline = time.monotonic() + _DIAL_TIMEOUT
    delays = Backoff(base=_DIAL_RETRY_DELAY, factor=1.7, max_delay=1.0,
                     retries=64, seed=hash(addr) & 0xFFFF).delays()
    while True:
        try:
            sock = socket.create_connection(addr, timeout=_DIAL_TIMEOUT)
            sock.settimeout(None)
            return sock
        except OSError:
            if closed.is_set() or time.monotonic() >= deadline:
                raise
            delay = next(delays, _DIAL_RETRY_DELAY)
            time.sleep(min(delay, max(0.0, deadline - time.monotonic())))


def _normalize(addr: str) -> str:
    """':8080' listens on all interfaces; dial via localhost."""
    return addr if not addr.startswith(":") else "127.0.0.1" + addr


def _parse_addr(addr: str) -> Tuple[str, int]:
    host, _, port = _normalize(addr).rpartition(":")
    return host or "127.0.0.1", int(port)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:], n - got)
        if r == 0:
            raise ConnectionError("connection closed mid-read")
        got += r
    return bytes(buf)


def _recv_frame(sock: socket.socket) -> Optional[dict]:
    """Read one length-prefixed JSON envelope; None on clean EOF."""
    try:
        hdr = _recv_exact(sock, _LEN.size)
    except ConnectionError:
        return None
    (size,) = _LEN.unpack(hdr)
    return json.loads(_recv_exact(sock, size))


def _sendmsg_all(sock: socket.socket, bufs) -> None:
    """``sendall`` over a scatter-gather list: every buffer goes out, in
    order, without ever concatenating them into a staging buffer —
    ``socket.sendmsg`` hands the kernel an iovec, so a layer frame's
    length prefix + JSON header + payload leave in one syscall with zero
    host-side joins (the old framing paid a ``bytes`` concat per frame,
    a full extra copy pass at physical layer sizes)."""
    views: List[memoryview] = [
        v for v in (memoryview(b).cast("B") for b in bufs) if len(v)
    ]
    while views:
        sent = sock.sendmsg(views)
        if sent == 0:
            raise ConnectionError("connection closed mid-write")
        while sent:
            if sent >= len(views[0]):
                sent -= len(views[0])
                views.pop(0)
            else:
                views[0] = views[0][sent:]
                sent = 0


def _send_frame(sock: socket.socket, envelope: dict) -> None:
    body = json.dumps(envelope).encode()
    _sendmsg_all(sock, (_LEN.pack(len(body)), body))


class _PConn:
    """A persistent control connection + its write lock
    (transport.go:42-45).  ``sock`` is None until the first dial completes;
    dialing happens under this connection's own lock so one unreachable
    peer never stalls sends to the others."""

    def __init__(self, sock: Optional[socket.socket] = None):
        self.sock = sock
        self.lock = threading.Lock()


class _ReadinessLoop:
    """The shared receive event loop: ONE selector thread drives every
    TcpTransport in the process, so connection count no longer implies
    thread count (docs/transport.md).

    Three fd kinds ride the selector:

    - **listener** — accepts inline; accepted connections register as
      conns (no per-connection thread, ever).
    - **conn** (accepted) — the loop parses the length-prefixed JSON
      envelope INCREMENTALLY with non-blocking reads (a stalled or
      malicious peer can never wedge the loop mid-frame).  A complete
      non-LAYER envelope is decoded and delivered inline — control
      traffic costs zero threads and can never be starved by slow layer
      bodies.  A LAYER envelope unregisters the connection and hands it
      to the bounded ``utils.threads.rx_pool()``: the worker
      blocking-reads the body through the unchanged zero-copy /
      stripe-regroup / cut-through paths (the sender is actively
      streaming it, and only layer bodies ever occupy a worker slot),
      then re-registers the connection at the next frame boundary.
    - **drain** — dialed control connections are write-only by protocol;
      the loop watches them for FIN/RST and evicts, replacing the old
      per-peer drain threads.

    Registration mutates the selector, which is not thread-safe against
    a concurrent ``select``: all mutations post to a command queue and
    wake the loop via a self-pipe."""

    def __init__(self):
        self._sel = selectors.DefaultSelector()
        self._cmds: "queue.Queue" = queue.Queue()
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._wake_w.setblocking(False)
        self._sel.register(self._wake_r, selectors.EVENT_READ,
                           {"kind": "wake"})
        threading.Thread(target=self._run, daemon=True,
                         name="tcp-evloop").start()

    # ------------------------------------------------------ registration

    def _post(self, fn) -> None:
        self._cmds.put(fn)
        try:
            self._wake_w.send(b"x")
        except (BlockingIOError, OSError):
            pass  # wake pipe full = the loop is already awake

    def _register(self, sock: socket.socket, rec: dict,
                  nonblocking: bool = True) -> None:
        try:
            if nonblocking:
                sock.setblocking(False)
        except OSError:
            if rec.get("kind") != "drain":
                rec["transport"]._discard_accepted(sock)
            return
        try:
            self._sel.register(sock, selectors.EVENT_READ, rec)
        except KeyError:
            # The kernel reuses fd NUMBERS: a socket closed before its
            # unwatch command ran leaves a stale selector entry that a
            # NEW socket with the same fd trips over.  Purge the stale
            # entry (it can never fire — epoll dropped the closed fd)
            # and register the live socket.
            try:
                stale = self._sel.get_key(sock)
                self._sel.unregister(stale.fileobj)
                self._sel.register(sock, selectors.EVENT_READ, rec)
            except (KeyError, ValueError, OSError):
                if rec.get("kind") != "drain":
                    rec["transport"]._discard_accepted(sock)
        except (ValueError, OSError):
            if rec.get("kind") != "drain":
                rec["transport"]._discard_accepted(sock)

    def watch_listener(self, transport: "TcpTransport",
                       sock: socket.socket) -> None:
        self._post(lambda: self._register(
            sock, {"kind": "listener", "transport": transport}))

    def watch_conn(self, transport: "TcpTransport",
                   sock: socket.socket) -> None:
        """(Re-)arm envelope parsing on an accepted connection.  Called
        at accept time and by a pool worker returning a connection at a
        frame boundary; a transport that closed meanwhile gets the
        socket closed instead of leaked into the selector."""
        if transport._closed.is_set():
            transport._discard_accepted(sock)
            return
        rec = {"kind": "conn", "transport": transport, "sock": sock,
               "buf": bytearray(), "need": _LEN.size, "phase": "len"}
        self._post(lambda: self._register(sock, rec))

    def watch_drain(self, transport: "TcpTransport", sock: socket.socket,
                    dest_addr: str, pconn: _PConn) -> None:
        # The dialed conn stays BLOCKING: senders write frames on it
        # concurrently (_send_frame under pconn.lock), and flipping it
        # non-blocking would make a full send buffer raise mid-frame.
        # The loop's drain read uses MSG_DONTWAIT instead.
        self._post(lambda: self._register(
            sock, {"kind": "drain", "transport": transport,
                   "addr": dest_addr, "pconn": pconn}, nonblocking=False))

    def unwatch_all(self, transport: "TcpTransport") -> None:
        """Drop every registration belonging to a closing transport."""

        def run():
            for key in [k for k in list(self._sel.get_map().values())
                        if k.data.get("transport") is transport]:
                try:
                    self._sel.unregister(key.fileobj)
                except (KeyError, ValueError, OSError):
                    pass

        self._post(run)

    # -------------------------------------------------------------- loop

    def _run(self) -> None:
        while True:
            try:
                events = self._sel.select()
            except OSError:
                time.sleep(0.01)  # a closed fd raced the select; retry
                continue
            # Wake bytes are consumed BEFORE the command drain — never
            # the other way around, or a command posted while we were
            # dispatching has its wake byte swallowed and sleeps until
            # the next unrelated event (a lost wakeup).
            try:
                while self._wake_r.recv(4096):
                    pass
            except (BlockingIOError, OSError):
                pass
            while True:
                try:
                    self._cmds.get_nowait()()
                except queue.Empty:
                    break
            for key, _ in events:
                rec = key.data
                kind = rec.get("kind")
                try:
                    if kind == "wake":
                        pass  # drained above
                    elif kind == "listener":
                        self._on_accept(key.fileobj, rec)
                    elif kind == "conn":
                        self._on_conn(key.fileobj, rec)
                    elif kind == "drain":
                        self._on_drain(key.fileobj, rec)
                except Exception as e:  # noqa: BLE001 — loop must survive
                    log.error("readiness loop dispatch failed",
                              kind=kind, err=repr(e))
                    self._drop(key.fileobj, rec)

    def _drop(self, sock, rec: dict) -> None:
        try:
            self._sel.unregister(sock)
        except (KeyError, ValueError, OSError):
            pass
        tr = rec.get("transport")
        if tr is not None:
            tr._discard_accepted(sock)
        else:
            try:
                sock.close()
            except OSError:
                pass

    def _on_accept(self, listener, rec: dict) -> None:
        tr: "TcpTransport" = rec["transport"]
        while True:
            try:
                conn, _ = listener.accept()
            except (BlockingIOError, OSError):
                return
            if tr._closed.is_set():
                conn.close()
                return
            with tr._lock:
                tr._accepted.add(conn)
            self.watch_conn(tr, conn)

    def _on_conn(self, sock, rec: dict) -> None:
        """Advance one connection's envelope parse as far as the kernel
        buffer allows; never blocks."""
        tr: "TcpTransport" = rec["transport"]
        while True:
            try:
                chunk = sock.recv(rec["need"] - len(rec["buf"]))
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                self._drop(sock, rec)
                return
            if not chunk:
                self._drop(sock, rec)  # clean EOF (or RST)
                return
            rec["buf"] += chunk
            if len(rec["buf"]) < rec["need"]:
                continue
            if rec["phase"] == "len":
                (rec["need"],) = _LEN.unpack(bytes(rec["buf"]))
                rec["buf"] = bytearray()
                rec["phase"] = "env"
                continue
            # One complete envelope.
            try:
                envelope = json.loads(bytes(rec["buf"]))
                mtype = MsgType(envelope["type"])
            except (ValueError, KeyError) as e:
                if not tr._closed.is_set():
                    log.error("receive loop failed", err=e)
                self._drop(sock, rec)
                return
            rec["buf"] = bytearray()
            rec["need"] = _LEN.size
            rec["phase"] = "len"
            if mtype != MsgType.LAYER:
                overflow = tr._deliver_control(mtype, envelope)
                if overflow is None:
                    continue
                # Delivery queue FULL: the consumer is wedged or
                # absent.  Take the CONNECTION off the loop and let a
                # pool worker do the blocking put, then re-register —
                # per-connection ordering is preserved (nobody else
                # reads the socket meanwhile) and the loop itself
                # never blocks.
                try:
                    self._sel.unregister(sock)
                except (KeyError, ValueError, OSError):
                    return
                threads.rx_pool().submit(tr._deliver_control_blocking,
                                         sock, overflow)
                return
            # Layer body follows: hand the connection to the bounded
            # worker pool for the (blocking) body read; the worker
            # re-registers at the next frame boundary.
            try:
                self._sel.unregister(sock)
            except (KeyError, ValueError, OSError):
                return
            threads.rx_pool().submit(tr._serve_layer_body, sock, envelope)
            return

    def _on_drain(self, sock, rec: dict) -> None:
        """Dialed control conns: peers never write here, so readable
        means FIN/RST (or stray bytes to discard) — evict so the next
        send re-dials."""
        tr: "TcpTransport" = rec["transport"]
        while True:
            try:
                data = sock.recv(4096, socket.MSG_DONTWAIT)
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                data = b""
            if data:
                continue  # discard unexpected bytes until EOF
            try:
                self._sel.unregister(sock)
            except (KeyError, ValueError, OSError):
                pass
            if not tr._closed.is_set():
                tr._evict(rec["addr"], rec["pconn"])
            return


_loop: Optional[_ReadinessLoop] = None
_loop_lock = threading.Lock()


def _readiness_loop() -> _ReadinessLoop:
    global _loop
    with _loop_lock:
        if _loop is None:
            _loop = _ReadinessLoop()
        return _loop


class TcpTransport(Transport):
    def __init__(
        self,
        addr: str,
        buf_size: int = 1024,
        addr_registry: Optional[AddrRegistry] = None,
        is_client: bool = False,
    ):
        self.addr = addr
        self.addr_registry: AddrRegistry = dict(addr_registry or {})
        self.is_client = is_client
        self._queue: "queue.Queue[Message]" = queue.Queue(maxsize=buf_size)
        self._conns: Dict[str, _PConn] = {}
        # dest addr -> idle data connections (LIFO: the hottest conn has
        # the widest cwnd).  Checked out per layer transfer, returned
        # after a clean send; never shared concurrently.
        self._data_pool: Dict[str, list] = {}
        self._accepted: "set[socket.socket]" = set()
        self._pipes: Dict[LayerID, NodeID] = {}
        # Striped receive state: (src_id, layer_id, tid) -> in-progress
        # reassembly group (no-sink receivers regroup stripes into the
        # original logical payload before delivery), completed-transfer
        # tombstones (a late duplicate stripe — a sender retry whose
        # first copy actually landed — must be drained, not resurrected
        # as a phantom group pinning a payload-sized buffer), and the
        # per-transfer relay countdowns for striped frames hitting a
        # registered pipe.
        self._stripe_groups: Dict[tuple, dict] = {}
        self._stripe_done: Dict[tuple, float] = {}
        self._stripe_relays: Dict[tuple, dict] = {}
        # Lazy background sweeper for the striped-receive TTLs: arrival-
        # time pruning alone would let the LAST abandoned transfer pin
        # its payload-sized buffer forever (nothing striped arrives
        # after it to trigger the sweep).  Started on first striped
        # state, exits with the transport.
        self._stripe_sweeper_started = False
        self._stripe_tid = itertools.count(
            int.from_bytes(os.urandom(4), "big") << 20
        )
        self._lock = threading.Lock()
        self._closed = threading.Event()
        # Zero-copy receive hook (set by a reassembling receiver):
        # sink(layer_id, total_size, offset, size) -> None, or
        # (view, token, abort_fn) — a writable memoryview straight into
        # the destination reassembly buffer, the coverage claim token
        # the handler will commit, and the rollback for a failed recv.
        # When it engages, fragment bytes go socket→assembly in ONE
        # copy (no bounce buffer, no handler memcpy) — the hot path at
        # physical layer sizes on memory-bandwidth-bound hosts.
        self.layer_sink = None
        # Integrity hooks (docs/integrity.md).  ``recv_tamper(info,
        # view) -> bool`` is the TEST-ONLY fault-injection hook
        # (transport/faults.py), run on a frame's landed bytes BEFORE
        # CRC verification — it may flip bytes in place (simulating wire
        # corruption below the checksum) or return False to inject a
        # drop.  ``on_corrupt(src_id, layer_id, offset, size,
        # total_size, reason)`` fires whenever a frame is dropped for a
        # failed check (or a stripe group is TTL-pruned): the receiver
        # runtime NACKs the source from it so the range is retransmitted
        # instead of waiting out crash detection.
        self.recv_tamper = None
        self.on_corrupt = None
        # Telemetry identity (utils/telemetry.py): the node id whose
        # (src, dest) links this transport's frame accounting files
        # under.  Bound by runtime.node.Node; None = record nothing.
        self.node_id = None

        host, port = _parse_addr(addr)
        self._listener = socket.create_server((host, port), reuse_port=False)
        # Record the kernel-chosen port when addr asked for :0 (tests).
        if port == 0:
            actual = self._listener.getsockname()[1]
            self.addr = f"{host}:{actual}" if not addr.startswith(":") else f":{actual}"
        log.info("start listening", addr=self.addr)
        # The shared readiness loop owns the listener AND every accepted
        # connection (docs/transport.md): accepts and control frames are
        # handled inline in the loop thread; layer bodies ride the
        # bounded rx pool — K connections never mean K threads.
        _readiness_loop().watch_listener(self, self._listener)

    # ------------------------------------------------------------------ rx

    def _discard_accepted(self, conn: socket.socket) -> None:
        with self._lock:
            self._accepted.discard(conn)
        try:
            conn.close()
        except OSError:
            pass

    def _deliver_control(self, mtype: MsgType, envelope: dict):
        """Deliver one inline-parsed control envelope; returns None on
        success (undecodable frames are dropped, logged, and count as
        delivered) or the DECODED message when the delivery queue is
        FULL — the caller (the readiness loop) then hands the whole
        connection plus the message to ``_deliver_control_blocking``,
        so the loop itself never blocks, per-connection frame order is
        preserved (nothing reads the socket until the blocked put
        lands), and the decode is paid exactly once."""
        try:
            msg = decode_msg(mtype, envelope["payload"])
        except (ValueError, KeyError) as e:
            if not self._closed.is_set():
                log.error("control frame decode failed", err=repr(e))
            return None
        try:
            self._queue.put_nowait(msg)
            return None
        except queue.Full:
            return msg

    def _deliver_control_blocking(self, conn: socket.socket, msg) -> None:
        """Pool worker: block until the full delivery queue accepts the
        message (the consumer's backpressure, like the old
        per-connection reader), then return the connection to the
        readiness loop."""
        while not self._closed.is_set():
            try:
                self._queue.put(msg, timeout=0.5)
                break
            except queue.Full:
                continue
        _readiness_loop().watch_conn(self, conn)

    def _serve_layer_body(self, conn: socket.socket, envelope: dict) -> None:
        """Pool worker: blocking-read one layer frame's body through the
        unchanged receive paths (zero-copy sink placement, stripe
        regroup, cut-through relay), then return the connection to the
        readiness loop at the frame boundary."""
        try:
            conn.setblocking(True)
            self._receive_layer(conn, envelope)
        except (ConnectionError, OSError, ValueError, KeyError) as e:
            if not self._closed.is_set():
                log.error("receive loop failed", err=e)
            self._discard_accepted(conn)
            return
        except BaseException:
            self._discard_accepted(conn)
            raise
        _readiness_loop().watch_conn(self, conn)

    def _frame_ok(self, header: LayerHeader, view,
                  notify: bool = True) -> Tuple[bool, float]:
        """Run the test-only tamper hook, then verify the frame's
        advisory CRC; ``(ok, crc_ms)``.  On False the frame must be
        DROPPED — the caller rolls back any sink claim; corruption is
        reported via ``on_corrupt`` unless ``notify`` is False (the
        regroup path reports the whole span instead, so the retransmit
        regroups as the one logical message plain receivers expect)."""
        reason = None
        tamper = self.recv_tamper
        if tamper is not None:
            info = {"src": header.src_id, "layer": header.layer_id,
                    "offset": header.offset, "size": header.layer_size,
                    "total": header.total_size,
                    "stripe_idx": header.stripe_idx,
                    "stripe_n": header.stripe_n}
            try:
                if tamper(info, view) is False:
                    reason = "drop"
            except Exception as e:  # noqa: BLE001 — test hook must not wedge rx
                log.error("recv_tamper hook failed", err=repr(e))
        crc_ms = 0.0
        if reason is None and integrity.wire_crc_enabled():
            # Verify whichever stamp is present (xxh3 preferred); CPU
            # seconds, not wall — on a contended host a wall span around
            # a GIL-released hash mostly measures the scheduler.
            t0 = time.thread_time()
            ok = integrity.verify_stamp(view, crc=header.crc,
                                        xxh3=header.xxh3)
            if ok is not None:
                crc_ms = (time.thread_time() - t0) * 1000
                trace.add_phase("integrity_crc_recv", crc_ms / 1000)
                if not ok:
                    reason = "crc"
        if reason is None:
            return True, crc_ms
        self._notify_corrupt(
            header.src_id, header.layer_id, header.offset,
            header.layer_size, header.total_size, reason,
            stripe=(f"{header.stripe_idx + 1}/{header.stripe_n}"
                    if header.stripe_n > 1 else ""),
            silent=not notify)
        return False, crc_ms

    def _notify_corrupt(self, src_id, layer_id, offset: int, size: int,
                        total: int, reason: str, stripe: str = "",
                        silent: bool = False) -> None:
        """Count + log + report one dropped byte range (the shared
        reporter — one wording/counter scheme across transports); the
        receiver runtime's ``on_corrupt`` hook turns the report into a
        ``LayerNackMsg`` so the source retransmits the range."""
        integrity.report_corrupt_frame(
            self.on_corrupt, src_id, layer_id, offset, size, total,
            reason, stripe=stripe, silent=silent, dest_id=self.node_id)

    def _telemetry_rx(self, header: LayerHeader, dur_ms: float,
                      crc_ms: float, placed: bool) -> None:
        """File one VERIFIED received frame on the (src, me) link of the
        flight recorder: wire bytes/frames, stripe occupancy, zero-copy
        placement, and the wire-wait vs verify stall split.  Dropped
        frames are filed by ``_notify_corrupt`` instead."""
        telemetry.link_add(
            header.src_id, self.node_id, job=header.job_id,
            rx_bytes=header.layer_size, rx_frames=1,
            rx_stripe_frames=1 if header.stripe_n > 1 else 0,
            rx_placed_frames=1 if placed else 0,
            wire_s=dur_ms / 1000.0, verify_s=crc_ms / 1000.0)
        telemetry.observe_ms("tcp.rx_frame_ms", dur_ms)

    def _receive_layer(self, conn: socket.socket, envelope: dict) -> None:
        header = LayerHeader.from_payload(envelope["payload"])
        if header.stripe_n > 1:
            self._receive_stripe(conn, envelope, header)
            return
        log.info(
            "start receiving layer",
            layerID=header.layer_id,
            layer_size=header.layer_size,
            total_size=header.total_size,
        )
        t0 = time.monotonic()

        pipe_sock = self._get_and_unregister_pipe(header.layer_id)
        placed = None
        if pipe_sock is None and self.layer_sink is not None:
            placed = self.layer_sink(header.layer_id, header.total_size,
                                     header.offset, header.layer_size)
        if placed is not None:
            view, token, abort = placed
            try:
                self._recv_body(conn, view, header.layer_size)
            except BaseException:
                abort()  # roll the claim back or the layer wedges forever
                raise
            ok, crc_ms = self._frame_ok(header, view)
            if not ok:
                # The bytes in the reassembly buffer are garbage, but the
                # claim rollback un-covers the range — the NACKed
                # retransmit overwrites it and only committed bytes are
                # ever read.
                abort()
                return
            dur_ms = (time.monotonic() - t0) * 1000
            self._telemetry_rx(header, dur_ms, crc_ms, placed=True)
            log.info(
                "(a fraction of) layer received",
                layerID=header.layer_id,
                offset=header.offset,
                layer_size=header.layer_size,
                total_size=header.total_size,
                duration_ms=round(dur_ms, 3),
                crc_ms=round(crc_ms, 3),
                placed=True,
            )
            src = LayerSrc(
                inmem_data=None, data_size=header.layer_size,
                offset=header.offset,
                meta=LayerMeta(location=LayerLocation.INMEM),
            )
            src.placed_token = token
            self._queue.put(LayerMsg(header.src_id, header.layer_id, src,
                                     header.total_size,
                                     job_id=header.job_id,
                                     shard=header.shard,
                                     codec=header.codec,
                                     span_id=header.span_id,
                                     span_parent=header.span_parent))
            return
        buf = alloc_recv_buffer(header.layer_size)
        view = memoryview(buf)
        if pipe_sock is not None:
            # Cut-through relay: stream chunks to the downstream node while
            # receiving (transport.go:144-196) — over a FRESH data
            # connection, like every other layer transfer, so a multi-GiB
            # relay never head-of-line blocks control messages to that peer
            # (the reference relays through the shared-mutex control
            # connection, transport.go:144-196 + :42-45).  The forwarded
            # header keeps the original src, matching the reference (TODO
            # at :152-164).
            try:
                _send_frame(pipe_sock, envelope)
                self._recv_body(conn, view, header.layer_size, pipe_sock)
            finally:
                pipe_sock.close()
        else:
            self._recv_body(conn, view, header.layer_size)

        # The pipe already teed the bytes downstream chunk-by-chunk — a
        # corrupt relay can't be recalled, but the downstream transport
        # verifies the SAME forwarded CRC and drops/NACKs it itself.
        ok, crc_ms = self._frame_ok(header, view)
        if not ok:
            return
        dur_ms = (time.monotonic() - t0) * 1000
        self._telemetry_rx(header, dur_ms, crc_ms, placed=False)
        log.info(
            "(a fraction of) layer received",
            layerID=header.layer_id,
            offset=header.offset,
            layer_size=header.layer_size,
            total_size=header.total_size,
            duration_ms=round(dur_ms, 3),
            crc_ms=round(crc_ms, 3),
        )
        layer_src = LayerSrc(
            inmem_data=buf,
            data_size=header.layer_size,
            offset=header.offset,
            meta=LayerMeta(location=LayerLocation.INMEM),
        )
        self._queue.put(
            LayerMsg(header.src_id, header.layer_id, layer_src,
                     header.total_size, job_id=header.job_id,
                     shard=header.shard, codec=header.codec,
                     span_id=header.span_id,
                     span_parent=header.span_parent)
        )

    # --------------------------------------------------------- striped rx

    def _recv_body(self, conn: socket.socket, view: memoryview,
                   n: int, pipe_sock=None) -> None:
        """Land a frame body's bytes in ``view`` (socket → destination
        buffer in ONE copy), optionally teeing each chunk to a
        cut-through pipe downstream.  The one receive loop shared by the
        striped and un-striped paths."""
        got = 0
        while got < n:
            if pipe_sock is None:
                r = conn.recv_into(view[got:], n - got)
            else:
                r = conn.recv_into(view[got:], min(_CHUNK, n - got))
            if r == 0:
                raise ConnectionError("connection closed mid-body")
            if pipe_sock is not None:
                pipe_sock.sendall(view[got : got + r])
            got += r

    def _stripe_pipe_sock(self, header: LayerHeader, envelope: dict):
        """Cut-through relay for a STRIPED frame: every stripe of the
        transfer relays over its own fresh downstream connection (they
        arrive concurrently on different sockets), and the one-shot pipe
        unregisters only once all ``stripe_n`` stripes relayed.  Returns
        the dialed downstream socket with the stripe envelope already
        forwarded, or None (no pipe / downstream unreachable)."""
        key = (header.src_id, header.layer_id, header.stripe_tid)
        with self._lock:
            rec = self._stripe_relays.get(key)
            if rec is None:
                if header.layer_id not in self._pipes:
                    return None
                # Claim the one-shot pipe for this whole striped transfer.
                dest_id = self._pipes.pop(header.layer_id)
                rec = self._stripe_relays[key] = {
                    "dest_id": dest_id, "done": set(),
                    "n": header.stripe_n, "t": time.monotonic()}
            else:
                rec["t"] = time.monotonic()
        # Failures below do NOT retire the stripe's relay slot: only a
        # fully-relayed stripe counts (``_stripe_relay_done``), so a
        # sender retry of a failed stripe gets relayed on its own fresh
        # downstream connection instead of the transfer silently losing
        # that byte range.  A record whose stripes never all land is
        # TTL-pruned with the rest of the striped-receive state.
        dest = self.addr_registry.get(rec["dest_id"])
        if dest is None:
            log.error("addr does not exist", dest=rec["dest_id"])
            return None
        try:
            sock = _dial(_parse_addr(dest), self._closed)
        except OSError as e:
            log.error("failed to connect pipe dest", dest=rec["dest_id"],
                      err=e)
            return None
        try:
            _send_frame(sock, envelope)
        except OSError as e:
            log.error("failed to forward stripe header", err=e)
            sock.close()
            return None
        return sock

    def _stripe_relay_done(self, key, stripe_idx: int) -> None:
        """Mark one DISTINCT stripe fully relayed; the claimed pipe's
        record retires once every stripe index has been (duplicate
        relays of a retried stripe collapse into the set)."""
        with self._lock:
            rec = self._stripe_relays.get(key)
            if rec is not None:
                rec["done"].add(stripe_idx)
                if len(rec["done"]) >= rec["n"]:
                    del self._stripe_relays[key]

    def _receive_stripe(self, conn: socket.socket, envelope: dict,
                        header: LayerHeader) -> None:
        """One stripe of a striped layer transfer.

        Three landings, in priority order (mirroring ``_receive_layer``):
        a registered pipe relays the stripe downstream while receiving
        (and still lands it locally); a zero-copy ``layer_sink`` places
        the stripe DIRECTLY at its absolute offset in the receiver's
        reassembly buffer and delivers it as its own fragment — so
        device staging begins per-stripe, overlapping the tail of the
        wire; otherwise stripes regroup transport-side into the original
        logical payload (plain receivers expect whole messages), landing
        each stripe at ``stripe_off`` in one shared buffer."""
        t0 = time.monotonic()
        with self._lock:
            # First striped arrival arms the background sweeper — the
            # TTL owner for ALL striped-receive state (groups,
            # tombstones, relay records), including the last abandoned
            # transfer that no later arrival would ever sweep.
            if not self._stripe_sweeper_started:
                self._stripe_sweeper_started = True
                threading.Thread(target=self._stripe_sweep_loop,
                                 name="tcp-stripe-sweep",
                                 daemon=True).start()
        pipe_sock = self._stripe_pipe_sock(header, envelope)
        key = (header.src_id, header.layer_id, header.stripe_tid)
        landed = False
        try:
            placed = None
            if self.layer_sink is not None:
                placed = self.layer_sink(header.layer_id, header.total_size,
                                         header.offset, header.layer_size)
            if placed is not None:
                view, token, abort = placed
                try:
                    self._recv_body(conn, view, header.layer_size,
                                           pipe_sock)
                except BaseException:
                    abort()
                    raise
                ok, crc_ms = self._frame_ok(header, view)
                if not ok:
                    # Claim rolled back; ``landed`` stays False so the
                    # relay slot isn't retired (the downstream copy is
                    # corrupt too and the retransmit must re-relay).
                    abort()
                    return
                landed = True
                src = LayerSrc(
                    inmem_data=None, data_size=header.layer_size,
                    offset=header.offset,
                    meta=LayerMeta(location=LayerLocation.INMEM),
                )
                src.placed_token = token
                self._log_stripe(header, t0, placed=True, crc_ms=crc_ms)
                self._queue.put(LayerMsg(
                    header.src_id, header.layer_id, src, header.total_size,
                    stripe_idx=header.stripe_idx, stripe_n=header.stripe_n,
                    stripe_off=header.stripe_off, job_id=header.job_id,
                    shard=header.shard, codec=header.codec,
                    span_id=header.span_id,
                    span_parent=header.span_parent))
                return
            if self.layer_sink is not None:
                # Sink present but declined (duplicate/overlap/finished):
                # bounce THIS stripe as its own fragment — the receiver's
                # interval reassembly (or its re-ack path) absorbs it.
                buf = alloc_recv_buffer(header.layer_size)
                self._recv_body(conn, memoryview(buf),
                                header.layer_size, pipe_sock)
                ok, crc_ms = self._frame_ok(header, memoryview(buf))
                if not ok:
                    return
                landed = True
                self._log_stripe(header, t0, placed=False, crc_ms=crc_ms)
                self._queue.put(LayerMsg(
                    header.src_id, header.layer_id,
                    LayerSrc(inmem_data=buf, data_size=header.layer_size,
                             offset=header.offset,
                             meta=LayerMeta(location=LayerLocation.INMEM)),
                    header.total_size,
                    stripe_idx=header.stripe_idx, stripe_n=header.stripe_n,
                    stripe_off=header.stripe_off, job_id=header.job_id,
                    shard=header.shard, codec=header.codec,
                    span_id=header.span_id,
                    span_parent=header.span_parent))
                return
            # No sink: regroup stripes into the original logical payload
            # so un-striped consumers (mode-0/1/2 receivers, raw
            # transport users) see exactly the message the sender passed
            # to send().  The group buffer is the final LayerSrc buffer —
            # stripes still land socket→payload in one copy.
            base = header.offset - header.stripe_off
            span = header.stripe_span
            done = None
            with self._lock:
                if key in self._stripe_done:
                    # Late duplicate of an already-delivered transfer (a
                    # sender retry whose first copy landed): drain the
                    # body, never resurrect a group for it.
                    rec = None
                else:
                    rec = self._stripe_groups.get(key)
                    if rec is None:
                        rec = self._stripe_groups[key] = {
                            "buf": alloc_recv_buffer(span), "span": span,
                            "base": base, "got": set(),
                            "t": time.monotonic(), "inflight": 0,
                            "total": header.total_size,
                        }
                    # The in-flight count keeps the prune off a group one
                    # of whose stripes is still mid-receive (a slow link
                    # can legitimately stream past the idle TTL).
                    rec["inflight"] += 1
                    rec["t"] = time.monotonic()
            if rec is None:
                self._drain_stripe_body(conn, header.layer_size, pipe_sock)
                landed = True
                return
            view = memoryview(rec["buf"])[
                header.stripe_off : header.stripe_off + header.layer_size]
            try:
                self._recv_body(conn, view, header.layer_size, pipe_sock)
            except BaseException:
                with self._lock:
                    rec["inflight"] -= 1
                raise
            ok, crc_ms = self._frame_ok(header, view, notify=False)
            if not ok:
                # A corrupt stripe poisons the whole regroup (plain
                # receivers expect ONE whole message, so a range
                # retransmit can't patch the group): tombstone it (late
                # sibling stripes drain; the retransmit's fresh tid
                # forms a new group) and NACK the WHOLE logical span.
                with self._lock:
                    rec["inflight"] -= 1
                    self._stripe_groups.pop(key, None)
                    self._stripe_done[key] = time.monotonic()
                integrity.fire_on_corrupt(
                    self.on_corrupt, header.src_id, header.layer_id,
                    base, span, header.total_size, "crc")
                return
            landed = True
            self._log_stripe(header, t0, placed=False, crc_ms=crc_ms)
            with self._lock:
                rec["inflight"] -= 1
                rec["got"].add(header.stripe_idx)
                rec["t"] = time.monotonic()
                if len(rec["got"]) >= header.stripe_n:
                    done = self._stripe_groups.pop(key, None)
                    if done is not None:
                        self._stripe_done[key] = time.monotonic()
            if done is not None:
                self._queue.put(LayerMsg(
                    header.src_id, header.layer_id,
                    LayerSrc(inmem_data=done["buf"], data_size=done["span"],
                             offset=done["base"],
                             meta=LayerMeta(location=LayerLocation.INMEM)),
                    done["total"],
                    stripe_idx=0, stripe_n=1, stripe_off=0,
                    job_id=header.job_id,
                    shard=header.shard, codec=header.codec,
                    span_id=header.span_id,
                    span_parent=header.span_parent))
        finally:
            if pipe_sock is not None:
                pipe_sock.close()
                if landed:
                    # Only a fully-relayed stripe retires its relay slot:
                    # a failed receive means the downstream copy is
                    # partial too, and the sender's retry must be relayed
                    # again (per-idx, so a duplicate can't over-retire).
                    self._stripe_relay_done(key, header.stripe_idx)

    def _drain_stripe_body(self, conn: socket.socket, n: int,
                           pipe_sock) -> None:
        """Consume (and discard) a stripe body that has no local landing
        — the connection framing must stay intact for whatever message
        follows on it.  A teed pipe still gets the bytes."""
        buf = memoryview(bytearray(min(n, _CHUNK)))
        got = 0
        while got < n:
            r = conn.recv_into(buf[: min(len(buf), n - got)])
            if r == 0:
                raise ConnectionError("connection closed mid-stripe")
            if pipe_sock is not None:
                pipe_sock.sendall(buf[:r])
            got += r

    def _stripe_sweep_loop(self) -> None:
        """Periodic TTL sweep of the striped-receive state (half-TTL
        cadence); exits when the transport closes.  NACKs for pruned
        groups fire OUTSIDE the lock — the receiver's ``on_corrupt``
        hook sends over this same transport, whose send path briefly
        takes ``self._lock``."""
        while not self._closed.wait(_STRIPE_GROUP_TTL / 2):
            with self._lock:
                notices = self._prune_stripe_groups_locked()
            for src_id, layer_id, base, span, total in notices:
                self._notify_corrupt(src_id, layer_id, base, span, total,
                                     "stale")

    def _prune_stripe_groups_locked(self) -> list:
        """Drop striped-receive state whose sender went silent (it died
        after exhausting its per-stripe retry) so abandoned transfers
        can't pin layer-sized buffers — or leak completion tombstones
        and relay countdowns — forever.  Groups with a stripe mid-recv
        (``inflight`` > 0) are never pruned.  Caller holds
        ``self._lock``.  Returns NACK notices ``(src, layer, base, span,
        total)`` for each abandoned group: the dead sender's half-layer
        is RE-REQUESTED from its source (best-effort — the source may be
        the dead sender itself, in which case crash detection remains
        the recovery) instead of silently discarded."""
        now = time.monotonic()
        notices = []
        for key in [k for k, r in self._stripe_groups.items()
                    if r["inflight"] <= 0
                    and now - r["t"] > _STRIPE_GROUP_TTL]:
            rec = self._stripe_groups.pop(key)
            log.warn("dropping stale stripe reassembly group", key=key)
            # Tombstone: straggler stripes of the pruned transfer drain
            # instead of resurrecting a fresh group for a dead tid.
            self._stripe_done[key] = now
            notices.append((key[0], key[1], rec["base"], rec["span"],
                            rec["total"]))
        for key in [k for k, t in self._stripe_done.items()
                    if now - t > _STRIPE_GROUP_TTL]:
            del self._stripe_done[key]
        for key in [k for k, r in self._stripe_relays.items()
                    if now - r["t"] > _STRIPE_GROUP_TTL]:
            log.warn("dropping stale stripe relay record", key=key)
            del self._stripe_relays[key]
        return notices

    def _log_stripe(self, header: LayerHeader, t0: float, placed: bool,
                    crc_ms: float = 0.0) -> None:
        self._telemetry_rx(header, (time.monotonic() - t0) * 1000,
                           crc_ms, placed=placed)
        log.info(
            "(a fraction of) layer received",
            layerID=header.layer_id,
            offset=header.offset,
            layer_size=header.layer_size,
            total_size=header.total_size,
            duration_ms=round((time.monotonic() - t0) * 1000, 3),
            crc_ms=round(crc_ms, 3),
            placed=placed,
            stripe=f"{header.stripe_idx + 1}/{header.stripe_n}",
        )

    # ------------------------------------------------------------------ tx

    def _get_or_connect(self, dest_addr: str) -> Optional[_PConn]:
        """Persistent control connection, dialed on demand
        (transport.go:228-256); None means 'myself'.  The registry lock is
        held only to look up/create the entry — the (possibly slow,
        retrying) dial runs under the per-connection lock."""
        if dest_addr == self.addr:
            return None
        with self._lock:
            pconn = self._conns.get(dest_addr)
            if pconn is None:
                pconn = _PConn()
                self._conns[dest_addr] = pconn
        with pconn.lock:
            if pconn.sock is None:
                try:
                    pconn.sock = _dial(_parse_addr(dest_addr), self._closed)
                except OSError:
                    self._evict(dest_addr, pconn)
                    raise
                # Watch the dialed conn for FIN/RST on the shared
                # readiness loop (the old per-peer drain thread).
                # Dialed control conns are write-only by protocol
                # (replies arrive on the PEER'S dial to OUR listener),
                # so readable means the peer closed — without the
                # watch, a peer restart leaves a half-closed socket in
                # the pool and the NEXT send to it succeeds silently
                # (TCP buffers the bytes, the RST arrives later): one
                # message vanishes without tripping the send path's
                # evict-and-redial retry.
                _readiness_loop().watch_drain(self, pconn.sock,
                                              dest_addr, pconn)
        return pconn

    def _evict(self, dest_addr: str, pconn: _PConn) -> None:
        """Drop a broken control connection so the next send re-dials."""
        with self._lock:
            if self._conns.get(dest_addr) is pconn:
                del self._conns[dest_addr]
        if pconn.sock is not None:
            try:
                pconn.sock.close()
            except OSError:
                pass

    def send(self, dest_id: NodeID, message: Message) -> None:
        dest = self.addr_registry.get(dest_id)
        if dest is None:
            raise KeyError(f"addr of {dest_id} does not exist")

        if isinstance(message, LayerMsg):
            streams = self._send_layer_pooled(dest, message)
            # Sent without raising: file the frame(s) on the (src, dest)
            # link — ``tx_stripe_frames / tx_frames`` is the run's
            # average stripe occupancy for the link.
            telemetry.link_add(
                message.src_id, dest_id, job=message.job_id,
                tx_bytes=message.layer_src.data_size, tx_frames=1,
                tx_stripe_frames=streams if streams > 1 else 0)
            return

        envelope = {
            "type": int(message.msg_type),
            "src": str(getattr(message, "src_id", self.addr)),
            "payload": message.to_payload(),
        }
        # A cached connection may have died (peer restart): evict and
        # re-dial with bounded jittered backoff (utils/backoff.py) —
        # the reference poisons the conn forever; the pre-backoff code
        # here retried exactly once, immediately, which a failover
        # window (leader seat rebinding) routinely outlasted.
        delays = Backoff(base=0.05, factor=2.0, max_delay=0.8,
                         retries=_SEND_RETRIES,
                         seed=hash(dest) & 0xFFFF).delays()
        for attempt in range(_SEND_RETRIES + 1):
            pconn = self._get_or_connect(dest)
            if pconn is None:
                self._queue.put(message)  # self-send short-circuit
                return
            try:
                with pconn.lock:
                    _send_frame(pconn.sock, envelope)
                return
            except OSError:
                self._evict(dest, pconn)
                if attempt >= _SEND_RETRIES:
                    raise
                time.sleep(next(delays, 0.05))

    def _send_layer_pooled(self, dest: str, message: LayerMsg) -> int:
        """One layer transfer over pooled data connection(s); returns
        the number of concurrent streams the payload rode (1 =
        un-striped) for the sender-side stripe-occupancy accounting.

        Payloads past ``STRIPE_THRESHOLD`` split into stripes riding
        several pooled connections CONCURRENTLY (``_send_layer_striped``)
        so one logical transfer can saturate the link instead of one
        socket; smaller (or rate-limited) payloads take the single-stream
        path below.

        A pooled connection may be stale (peer restarted while it idled):
        the first attempt may fail mid-stream, in which case the transfer
        retries once on a FRESH dial.  A half-sent fragment on the dead
        connection is harmless — the receiver drops partial bodies on
        connection error, and interval reassembly tolerates the re-send.
        """
        src = message.layer_src
        if (STRIPE_COUNT > 1
                and src.data_size >= max(STRIPE_THRESHOLD, 2 * STRIPE_MIN)
                and (src.meta.limit_rate == 0
                     or src.meta.limit_rate >= STRIPE_PACED_MIN_RATE)
                and src.meta.location in (LayerLocation.INMEM,
                                          LayerLocation.HBM,
                                          LayerLocation.DISK)):
            spans = stripe_offsets(src.data_size, STRIPE_COUNT, STRIPE_MIN)
            if len(spans) > 1 and self._send_layer_striped(
                    dest, message, spans):
                return len(spans)
        self._send_one_stream(dest, message)
        return 1

    def _send_one_stream(self, dest: str, message: LayerMsg,
                         stripe: Optional[dict] = None) -> None:
        """One byte stream (a whole payload, or one stripe of one) over a
        pooled data connection, with the stale-connection retry: attempt
        0 uses a pooled conn (free to fail — the peer may have restarted
        while it idled), later attempts dial FRESH with jittered
        exponential backoff (utils/backoff.py) before the OSError
        surfaces.  A half-sent fragment on a dead connection is harmless
        — the receiver drops partial bodies on connection error, and
        interval reassembly tolerates the re-send."""
        delays = Backoff(base=0.05, factor=2.0, max_delay=0.8,
                         retries=_SEND_RETRIES,
                         seed=(hash(dest) ^ message.layer_id) & 0xFFFF
                         ).delays()
        for attempt in range(_SEND_RETRIES + 1):
            fresh = attempt > 0
            last = attempt >= _SEND_RETRIES
            sock = None
            try:
                sock = (self._dial_data(dest) if fresh
                        else self._acquire_data_conn(dest))
                self._send_layer(sock, message, stripe=stripe)
            except OSError:
                if sock is not None:
                    sock.close()  # state unknown: never pool a broken conn
                if last:
                    raise
                time.sleep(next(delays, 0.05))
                continue
            except Exception:
                # Non-socket failure (e.g. an unserveable LayerSrc) can
                # strike after the header frame is on the wire: the conn
                # is mid-message — close it, never pool it, don't retry.
                if sock is not None:
                    sock.close()
                raise
            self._release_data_conn(dest, sock)
            return

    def _send_layer_striped(self, dest: str, message: LayerMsg,
                            spans) -> bool:
        """Send one logical payload as ``len(spans)`` stripes over that
        many pooled data connections in parallel.  Each stripe is an
        independent single-stream send (own pooled checkout, own stale
        retry); the first stripe runs on the calling thread.  Returns
        False without touching the wire when the source can't serve
        concurrent range reads (the caller then streams it whole)."""
        src = message.layer_src
        if src.meta.location == LayerLocation.HBM and src.inmem_data is None:
            # One device→host fetch up front; stripes then slice host RAM.
            if not src.ensure_host_bytes():
                return False
        if (src.meta.location in (LayerLocation.INMEM, LayerLocation.HBM)
                and src.inmem_data is None):
            return False
        tid = f"{next(self._stripe_tid):x}"
        n = len(spans)
        errors: List[BaseException] = []

        def send_stripe(idx: int, rel_off: int, size: int) -> None:
            meta = src.meta
            if meta.limit_rate > 0:
                # Split the commanded budget proportionally: N paced
                # stripes together still flow at (almost exactly) the
                # allotted rate.
                meta = LayerMeta(
                    location=meta.location,
                    limit_rate=max(1, meta.limit_rate * size
                                   // src.data_size),
                    source_type=meta.source_type,
                )
            sub = LayerSrc(
                inmem_data=src.inmem_data, fp=src.fp, data_size=size,
                offset=src.offset + rel_off, meta=meta,
            )
            stripe = {"idx": idx, "n": n, "off": rel_off,
                      "span": src.data_size, "tid": tid}
            try:
                self._send_one_stream(
                    dest,
                    LayerMsg(message.src_id, message.layer_id, sub,
                             message.total_size, job_id=message.job_id,
                             shard=message.shard, codec=message.codec,
                             span_id=message.span_id,
                             span_parent=message.span_parent),
                    stripe=stripe)
            except BaseException as e:  # noqa: BLE001 — re-raised below
                errors.append(e)

        # Concurrent stripes ride the bounded tx pool (utils/threads.py)
        # — stripe 0 runs on the calling thread (run_all's guaranteed-
        # progress slot), so a saturated pool serializes extra stripes
        # instead of spawning a thread per stripe.
        threads.tx_pool().run_all(
            [(send_stripe, i, off, size)
             for i, (off, size) in enumerate(spans)])
        if errors:
            raise errors[0]
        return True

    def _dial_data(self, dest: str) -> socket.socket:
        return _dial(_parse_addr(dest), self._closed)

    def _acquire_data_conn(self, dest: str) -> socket.socket:
        with self._lock:
            pool = self._data_pool.get(dest)
            if pool:
                return pool.pop()
        return self._dial_data(dest)

    def _release_data_conn(self, dest: str, sock: socket.socket) -> None:
        with self._lock:
            if not self._closed.is_set():
                self._data_pool.setdefault(dest, []).append(sock)
                return
        sock.close()

    def _send_layer(self, sock: socket.socket, message: LayerMsg,
                    stripe: Optional[dict] = None) -> None:
        """Header then raw body (transport.go:308-373).  In-memory bodies
        ride the header's scatter-gather ``sendmsg`` (no concat, one
        syscall batch); disk bodies keep the kernel ``sendfile`` path —
        including disk-backed STRIPES, which sendfile serves by
        (offset, count) with no host read at all.  Every frame is
        stamped with the advisory checksum (xxh3-64 where available,
        crc32 otherwise — ``integrity.fragment_checksum``) of exactly
        its payload bytes (per stripe), computed BEFORE anything touches
        the wire."""
        src = message.layer_src
        header = LayerHeader(
            src_id=message.src_id,
            layer_id=message.layer_id,
            layer_size=src.data_size,
            total_size=message.total_size,
            offset=src.offset,
            job_id=message.job_id,
            shard=message.shard,
            codec=message.codec,
            span_id=message.span_id,
            span_parent=message.span_parent,
        )
        if stripe is not None:
            header.stripe_idx = stripe["idx"]
            header.stripe_n = stripe["n"]
            header.stripe_off = stripe["off"]
            header.stripe_span = stripe["span"]
            header.stripe_tid = stripe["tid"]

        # HBM-staged layers keep their host buffer and serve like INMEM;
        # fabric-delivered layers never had one — materialize it from the
        # device array (one cached device→host fetch) so an HBM owner can
        # re-serve over the host path too.
        if (src.meta.location == LayerLocation.HBM
                and src.inmem_data is None):
            src.ensure_host_bytes()
        data = None
        if (src.meta.location in (LayerLocation.INMEM, LayerLocation.HBM)
                and src.inmem_data is not None):
            data = memoryview(src.inmem_data)[src.offset : src.offset + src.data_size]
        if message.crc is not None or message.xxh3 is not None:
            header.crc = message.crc  # caller-stamped (tests)
            header.xxh3 = message.xxh3
        elif integrity.wire_crc_enabled():
            t_crc = time.thread_time()
            stamp = None
            if data is not None:
                stamp = integrity.fragment_checksum(data)
            elif src.meta.location == LayerLocation.DISK and src.fp:
                # One warm page-cache checksum sweep; the body itself
                # still leaves via kernel sendfile below.
                stamp = integrity.file_checksum(src.fp, src.offset,
                                                src.data_size)
            if stamp is not None:
                algo, value = stamp
                if algo == "xxh3":
                    header.xxh3 = value
                else:
                    header.crc = value
                trace.add_phase("integrity_crc_send",
                                time.thread_time() - t_crc)
        envelope = {
            "type": int(MsgType.LAYER),
            "src": str(message.src_id),
            "payload": header.to_payload(),
        }
        if data is not None:
            if src.meta.limit_rate > 0:
                _send_frame(sock, envelope)
                log.debug(
                    "sending with limit",
                    layerID=message.layer_id,
                    mibps=src.meta.limit_rate >> 20,
                )
                PacedWriter(sock.sendall, src.meta.limit_rate).write(data)
            else:
                body = json.dumps(envelope).encode()
                _sendmsg_all(sock, (_LEN.pack(len(body)), body, data))
        elif src.meta.location == LayerLocation.DISK:
            if not src.fp:
                raise ValueError("no data source specified")
            _send_frame(sock, envelope)
            # Zero-copy kernel sendfile, the io.Copy(SectionReader) path.
            with open(src.fp, "rb") as f:
                sock.sendfile(f, offset=src.offset, count=src.data_size)
        else:
            raise ValueError(f"cannot send layer {message.layer_id} from {src.meta}")

    def broadcast(self, message: Message) -> None:
        with self._lock:
            ids = list(self.addr_registry)
        for dest_id in ids:
            try:
                self.send(dest_id, message)
            except (OSError, KeyError) as e:
                log.error("failed to broadcast", dest=dest_id, err=e)

    # ------------------------------------------------------------------ pipes

    def register_pipe(self, layer_id: LayerID, dest_id: NodeID) -> None:
        with self._lock:
            if layer_id in self._pipes:
                raise ValueError("pipe already registered")
            self._pipes[layer_id] = dest_id

    def _get_and_unregister_pipe(self, layer_id: LayerID) -> Optional[socket.socket]:
        """Fresh data connection to the pipe's downstream node (closed by
        the relay when the layer completes)."""
        with self._lock:
            dest_id = self._pipes.pop(layer_id, None)
        if dest_id is None:
            return None
        dest = self.addr_registry.get(dest_id)
        if dest is None:
            log.error("addr does not exist", dest=dest_id)
            return None
        try:
            return _dial(_parse_addr(dest), self._closed)
        except OSError as e:
            log.error("failed to connect pipe dest", dest=dest_id, err=e)
            return None

    # ------------------------------------------------------------------ misc

    def deliver(self) -> "queue.Queue[Message]":
        return self._queue

    def get_address(self) -> str:
        return self.addr

    def close(self) -> None:
        self._closed.set()
        # Unhook from the shared readiness loop first, so the selector
        # stops dispatching on sockets the shutdown below is closing.
        _readiness_loop().unwatch_all(self)
        try:
            # shutdown() wakes the thread blocked in accept(); close()
            # alone leaves the kernel listener alive (the syscall holds a
            # reference) and the port stays bound.
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._listener.close()
        except OSError:
            pass
        with self._lock:
            conns = list(self._conns.values())
            self._conns.clear()
            pooled = [s for pool in self._data_pool.values() for s in pool]
            self._data_pool.clear()
            accepted = list(self._accepted)
            self._accepted.clear()
        # shutdown() before close(), for the same reason as the listener
        # above: a thread blocked in recv() on the socket holds the
        # kernel file reference, so close() alone sends NO FIN until
        # that syscall returns — peers would never learn we went away
        # (their drain threads keep the stale conn pooled, and their
        # next send to this seat's address silently vanishes).
        for sock in pooled + [p.sock for p in conns if p.sock] + accepted:
            for op in (lambda: sock.shutdown(socket.SHUT_RDWR), sock.close):
                try:
                    op()
                except OSError:
                    pass
