"""App launcher: python -m polgen_rvc_tpu_torch.app.main
       [--port N] [--open] [--listen] [--share RELAY_HOST:TUNNEL_PORT]
       [--share-secret S]  (or POLGEN_SHARE_SECRET env)

The port of the JAX package's app/main.py: it serves the port's UI
(app/ui/server.py), whose conversions run on CUDA (without a card it
raises before binding). The reference launcher's semantics: default port
7860, --port override, --open launches a browser, a port-retry loop
decrementing on bind failure. --share publishes the UI through the
first-party relay (app/share_tunnel.py: run `python -m
polgen_rvc_tpu_torch.app.share_tunnel relay` on a public box); bare
`--share` without a relay address is accepted and reported unavailable.
Binds 127.0.0.1 unless --listen is given (the API accepts filesystem
paths, so external exposure is opt-in).
"""

from __future__ import annotations

import os
import sys
import webbrowser

DEFAULT_PORT = 7860
MAX_PORT_ATTEMPTS = 10


def get_port_from_args(argv=None) -> int:
    argv = argv if argv is not None else sys.argv
    if "--port" in argv:
        idx = argv.index("--port") + 1
        if idx < len(argv):
            return int(argv[idx])
    return DEFAULT_PORT


def main(argv=None):
    argv = argv if argv is not None else sys.argv
    from .ui.server import serve

    share_relay = None
    if "--share" in argv:
        idx = argv.index("--share") + 1
        if idx < len(argv) and ":" in argv[idx]:
            share_relay = argv[idx]
        else:
            print("[!] --share needs a relay address (HOST:TUNNEL_PORT); "
                  "run `python -m polgen_rvc_tpu_torch.app.share_tunnel relay` "
                  "on a public host first. Serving locally only.")
    share_secret = os.environ.get("POLGEN_SHARE_SECRET", "")
    if "--share-secret" in argv:
        idx = argv.index("--share-secret") + 1
        if idx >= len(argv):
            # silently falling back to the env/empty secret would fail the
            # relay handshake later with a misleading "relay unavailable"
            raise SystemExit(
                "[!] --share-secret requires a value (the relay's shared "
                "secret); none was given"
            )
        share_secret = argv[idx]
    host = "0.0.0.0" if "--listen" in argv else "127.0.0.1"
    port = get_port_from_args(argv)

    def on_bound(bound_port: int) -> None:
        # runs only after the UI socket bound: a failed bind + port retry
        # never dials the relay for a dead port
        if "--open" in argv:
            webbrowser.open(f"http://localhost:{bound_port}")
        if share_relay:
            from .share_tunnel import start_share_client

            # share failure degrades to local-only serving: letting the
            # OSError escape would hit main's bind-retry loop, which would
            # misread a relay problem as a port conflict and walk down
            # ports leaking bound-but-unserved sockets
            try:
                start_share_client(
                    share_relay, bound_port, secret=share_secret
                )
                print(f"[+] sharing through relay {share_relay}")
            except OSError as e:
                print(f"[!] share relay unavailable ({e}); "
                      "serving locally only")

    for _ in range(MAX_PORT_ATTEMPTS):
        try:
            serve(port, host=host, on_bound=on_bound)
            break
        except OSError:
            print(f"could not bind port {port}, retrying on port {port - 1}...")
            port -= 1
        except KeyboardInterrupt:
            break


if __name__ == "__main__":
    main()
