"""First-party public-share tunnel (the reference's --share, self-hosted):
the port of the JAX package's app/share_tunnel.py, byte for byte the same
protocol.

The reference exposes the UI publicly through gradio's third-party FRP
relay. This package ships both halves of an equivalent, dependency-free
tunnel instead:

  relay  (run on any box with a public address):
      python -m polgen_rvc_tpu_torch.app.share_tunnel relay \
          --public-port 8080 --tunnel-port 8081
  app    (behind NAT, dials OUT to the relay):
      python -m polgen_rvc_tpu_torch.app.main --share RELAY_HOST:8081

One outbound TCP connection carries every browser session, multiplexed
with a tiny binary framing:

    frame := stream_id:u32be  kind:u8  length:u32be  payload[length]
    kind  := 0 OPEN (relay->app: new browser connection)
             1 DATA (either direction)
             2 CLOSE (either direction)

The relay accepts browsers on --public-port, assigns each a stream id,
and forwards bytes; the app side opens a loopback connection to the UI
server per stream and pipes. The tunnel port requires a shared-secret
handshake (`--secret` on the relay, the same value on the app side) so a
public relay's control port cannot be claimed by a stranger; the UI it
publishes accepts filesystem paths, so only expose it where the
reference's gradio share link would have been acceptable. The relay
survives app restarts: when a tunnel dies it drops its streams and
re-accepts a replacement. Loopback-tested end to end in
tests/test_torch_share_tunnel.py.
"""

from __future__ import annotations

import argparse
import hmac
import socket
import struct
import threading

_HDR = struct.Struct(">IBI")
OPEN, DATA, CLOSE = 0, 1, 2
_CHUNK = 65536
_MAGIC = b"POLGEN-SHARE-1 "
_HANDSHAKE_MAX = 256


def _send_handshake(sock: socket.socket, secret: str,
                    timeout: float = 10.0) -> None:
    """Present the secret and wait for the relay's OK ack — without the
    ack a rejected client would see a live-looking socket and report
    success while the relay silently dropped it."""
    sock.sendall(_MAGIC + secret.encode() + b"\n")
    sock.settimeout(timeout)
    try:
        if _recv_exact(sock, 3) != b"OK\n":
            raise ConnectionError("relay rejected the share handshake")
    except ConnectionError:
        raise ConnectionError(
            "relay rejected the share handshake (bad --share secret?)"
        ) from None
    finally:
        try:
            sock.settimeout(None)
        except OSError:
            pass


def _check_handshake(sock: socket.socket, secret: str,
                     timeout: float = 5.0) -> bool:
    """Read `MAGIC secret\\n` off a fresh tunnel connection; constant-time
    secret compare. Returns False on timeout/garbage/mismatch."""
    sock.settimeout(timeout)
    try:
        buf = b""
        while b"\n" not in buf:
            if len(buf) > _HANDSHAKE_MAX:
                return False
            part = sock.recv(_HANDSHAKE_MAX)
            if not part:
                return False
            buf += part
        line = buf.split(b"\n", 1)[0]
        if not line.startswith(_MAGIC):
            return False
        return hmac.compare_digest(line[len(_MAGIC):], secret.encode())
    except OSError:
        return False
    finally:
        try:
            sock.settimeout(None)
        except OSError:
            pass


def _send_frame(sock: socket.socket, lock: threading.Lock, stream_id: int,
                kind: int, payload: bytes = b"") -> None:
    with lock:
        sock.sendall(_HDR.pack(stream_id, kind, len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        part = sock.recv(n - len(buf))
        if not part:
            raise ConnectionError("tunnel closed")
        buf += part
    return buf


def _pipe_to_tunnel(conn: socket.socket, tunnel: socket.socket,
                    lock: threading.Lock, stream_id: int) -> None:
    """Local/browser socket -> framed tunnel; CLOSE on EOF."""
    try:
        while True:
            data = conn.recv(_CHUNK)
            if not data:
                break
            _send_frame(tunnel, lock, stream_id, DATA, data)
    except OSError:
        pass
    try:
        _send_frame(tunnel, lock, stream_id, CLOSE)
    except OSError:
        pass


class _Streams:
    """stream_id -> local socket, with locked mutation."""

    def __init__(self):
        self._lock = threading.Lock()
        self._socks: dict = {}

    def put(self, sid: int, sock) -> None:
        with self._lock:
            self._socks[sid] = sock

    def get(self, sid: int):
        with self._lock:
            return self._socks.get(sid)

    def pop(self, sid: int):
        with self._lock:
            return self._socks.pop(sid, None)

    def close_all(self) -> None:
        with self._lock:
            socks, self._socks = list(self._socks.values()), {}
        for s in socks:
            try:
                s.close()
            except OSError:
                pass


def _demux_loop(tunnel: socket.socket, streams: _Streams, on_open=None,
                lock: threading.Lock = None) -> None:
    """Read frames off the tunnel and route them to per-stream sockets.
    Returns when the tunnel dies; the CALLER decides what to tear down —
    a superseded relay tunnel must NOT close the replacement's streams."""
    try:
        while True:
            sid, kind, length = _HDR.unpack(_recv_exact(tunnel, _HDR.size))
            payload = _recv_exact(tunnel, length) if length else b""
            if kind == OPEN and on_open is not None:
                on_open(sid)
            elif kind == DATA:
                sock = streams.get(sid)
                if sock is not None:
                    try:
                        sock.sendall(payload)
                    except OSError:
                        streams.pop(sid)
            elif kind == CLOSE:
                sock = streams.pop(sid)
                if sock is not None:
                    try:
                        sock.close()
                    except OSError:
                        pass
    except (ConnectionError, OSError):
        pass


# ---------------------------------------------------------------------------
# app side
# ---------------------------------------------------------------------------


def start_share_client(relay: str, local_port: int,
                       secret: str = "") -> threading.Thread:
    """Dial the relay's tunnel port and serve OPEN requests by proxying to
    the local UI server. Returns the (daemon) demux thread."""
    host, _, port_s = relay.partition(":")
    tunnel = socket.create_connection((host, int(port_s) or 8081))
    _send_handshake(tunnel, secret)
    lock = threading.Lock()
    streams = _Streams()

    def on_open(sid: int) -> None:
        try:
            local = socket.create_connection(("127.0.0.1", local_port))
        except OSError:
            _send_frame(tunnel, lock, sid, CLOSE)
            return
        streams.put(sid, local)
        threading.Thread(
            target=_pipe_to_tunnel, args=(local, tunnel, lock, sid),
            daemon=True,
        ).start()

    def demux():
        _demux_loop(tunnel, streams, on_open, lock)
        streams.close_all()  # our tunnel died: all its streams are dead

    t = threading.Thread(target=demux, daemon=True)
    t.start()
    return t


# ---------------------------------------------------------------------------
# relay side
# ---------------------------------------------------------------------------


def run_relay(public_port: int, tunnel_port: int, host: str = "0.0.0.0",
              ready_event: threading.Event = None,
              stop_event: threading.Event = None,
              secret: str = "") -> None:
    """Accept app tunnels (one live at a time, re-accepted after disconnect)
    and any number of browsers; forward between. Tunnel connections must
    pass the shared-secret handshake or they are dropped."""
    tsrv = socket.create_server((host, tunnel_port))
    psrv = socket.create_server((host, public_port))
    tsrv.settimeout(0.5)
    psrv.settimeout(0.5)
    if ready_event is not None:
        ready_event.set()

    lock = threading.Lock()
    streams = _Streams()
    next_sid = [1]
    # the live tunnel socket; None while no (authenticated) app is attached
    tunnel_box: dict = {"sock": None}

    def drop_tunnel(sock) -> None:
        """Deactivate `sock` if it is still the live tunnel; only then tear
        down streams — a stale superseded tunnel dying must not close the
        replacement's browser connections."""
        with lock:
            mine = tunnel_box["sock"] is sock
            if mine:
                tunnel_box["sock"] = None
        if mine:
            streams.close_all()
        try:
            sock.close()
        except OSError:
            pass

    # at most this many candidates may sit in the (5 s-timeout) handshake
    # at once: a connection flood on the public tunnel port would otherwise
    # accumulate one thread + fd per SYN without bound. Excess candidates
    # are dropped immediately; a legitimate app client just re-dials.
    handshake_slots = threading.BoundedSemaphore(8)

    def attach(cand) -> None:
        """Handshake + supersede + demux for one tunnel candidate. Runs in
        its own thread so an unauthenticated probe holding the 5 s
        handshake timeout cannot starve a legitimate (re)connection."""
        try:
            if not _check_handshake(cand, secret):
                try:
                    cand.close()
                except OSError:
                    pass
                return
        finally:
            handshake_slots.release()
        try:
            cand.sendall(b"OK\n")
        except OSError:
            try:
                cand.close()
            except OSError:
                pass
            return
        # supersede: the old tunnel and its streams are dead either way.
        # Deactivate + drain BEFORE installing cand so no close races the
        # replacement's fresh streams.
        with lock:
            old = tunnel_box["sock"]
            tunnel_box["sock"] = None
        streams.close_all()
        if old is not None:
            try:
                old.close()
            except OSError:
                pass
        with lock:
            tunnel_box["sock"] = cand
        _demux_loop(cand, streams, None, lock)
        drop_tunnel(cand)

    def wait_tunnel():
        while stop_event is None or not stop_event.is_set():
            try:
                cand, _ = tsrv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            if not handshake_slots.acquire(blocking=False):
                try:
                    cand.close()
                except OSError:
                    pass
                continue
            threading.Thread(target=attach, args=(cand,), daemon=True).start()

    threading.Thread(target=wait_tunnel, daemon=True).start()
    try:
        while stop_event is None or not stop_event.is_set():
            try:
                browser, _ = psrv.accept()
            except socket.timeout:
                continue
            tunnel = tunnel_box["sock"]
            if tunnel is None:
                browser.close()  # no app attached yet
                continue
            sid = next_sid[0]
            next_sid[0] += 1
            streams.put(sid, browser)
            try:
                _send_frame(tunnel, lock, sid, OPEN)
            except OSError:
                # tunnel died between accept and OPEN: drop it and keep
                # serving — the app can re-dial (wait_tunnel still runs)
                streams.pop(sid)
                browser.close()
                drop_tunnel(tunnel)
                continue
            threading.Thread(
                target=_pipe_to_tunnel, args=(browser, tunnel, lock, sid),
                daemon=True,
            ).start()
    finally:
        tsrv.close()
        psrv.close()
        streams.close_all()


def main(argv=None):
    ap = argparse.ArgumentParser(prog="share_tunnel")
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("relay", help="run the public relay")
    r.add_argument("--public-port", type=int, default=8080)
    r.add_argument("--tunnel-port", type=int, default=8081)
    r.add_argument("--host", default="0.0.0.0")
    r.add_argument("--secret", default="",
                   help="shared secret the app must present on the tunnel "
                        "port (default: empty — open relay)")
    args = ap.parse_args(argv)
    if args.cmd == "relay":
        print(f"share relay: browsers -> :{args.public_port}, "
              f"app tunnel -> :{args.tunnel_port}"
              + (" (secret required)" if args.secret else ""))
        run_relay(args.public_port, args.tunnel_port, host=args.host,
                  secret=args.secret)


if __name__ == "__main__":
    main()
