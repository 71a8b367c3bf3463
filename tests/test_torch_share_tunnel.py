"""The port's share tunnel and launcher, on loopback.

The four cases of tests/test_share_tunnel.py on the port's modules: its
three tunnel cases are the JAX package's test bodies, with every tunnel
function they call (the relay, the client and the raw handshake) swapped
for the port's, and its launcher case runs the port's main. Then the two
packages' relay and client against each other, which shows the same
framing and handshake on the wire, and the port's launcher."""

import http.client
import http.server
import threading
import time

import pytest
import torch

import polgen_rvc_tpu.app.share_tunnel as jax_tunnel
import test_share_tunnel as jax_cases
from polgen_rvc_tpu_torch.app import main as app_main
from polgen_rvc_tpu_torch.app import share_tunnel
from test_torch_pipeline import one_intra_op_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("case", ["test_share_tunnel_roundtrip",
                                  "test_share_tunnel_handshake_flood_capped",
                                  "test_share_tunnel_secret_and_reconnect"])
def test_jax_case_on_the_port(case, monkeypatch):
    monkeypatch.setattr(jax_cases, "run_relay", share_tunnel.run_relay)
    monkeypatch.setattr(jax_cases, "start_share_client", share_tunnel.start_share_client)
    monkeypatch.setattr(jax_tunnel, "_send_handshake", share_tunnel._send_handshake)
    getattr(jax_cases, case)()


def test_main_share_secret_requires_value():
    with pytest.raises(SystemExit):
        app_main.main(["--share-secret"])


@pytest.mark.parametrize("relay_side,client_side", [(share_tunnel, jax_tunnel),
                                                    (jax_tunnel, share_tunnel)],
                         ids=["port_relay", "port_client"])
def test_port_and_jax_halves_interoperate(relay_side, client_side):
    assert share_tunnel._HDR.format == jax_tunnel._HDR.format == ">IBI"
    assert share_tunnel._MAGIC == jax_tunnel._MAGIC
    ui_port, public_port, tunnel_port = (jax_cases._free_port() for _ in range(3))
    ui = http.server.ThreadingHTTPServer(("127.0.0.1", ui_port), jax_cases._Handler)
    threading.Thread(target=ui.serve_forever, daemon=True).start()
    ready, stop = threading.Event(), threading.Event()
    threading.Thread(target=relay_side.run_relay, args=(public_port, tunnel_port),
                     kwargs={"host": "127.0.0.1", "ready_event": ready,
                             "stop_event": stop, "secret": "s3"},
                     daemon=True).start()
    assert ready.wait(5.0)
    try:
        client_side.start_share_client(f"127.0.0.1:{tunnel_port}", ui_port, secret="s3")
        time.sleep(0.3)
        conn = http.client.HTTPConnection("127.0.0.1", public_port, timeout=5)
        payload = b"y" * 150_000  # several 64 KiB frames each way
        conn.request("POST", "/mixed", body=payload)
        resp = conn.getresponse()
        assert (resp.status, resp.read()) == (200, b"echo:" + payload)
        conn.close()
    finally:
        stop.set()
        ui.shutdown()
        ui.server_close()


def test_launcher_ports_and_no_card(monkeypatch):
    """--port parses as the JAX launcher's; without CUDA the launcher raises
    before it binds a port (the UI's conversions need the card)."""
    assert app_main.get_port_from_args(["x"]) == app_main.DEFAULT_PORT == 7860
    assert app_main.get_port_from_args(["x", "--port", "7000"]) == 7000
    assert app_main.MAX_PORT_ATTEMPTS == 10
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        app_main.main(["x", "--port", "0"])
