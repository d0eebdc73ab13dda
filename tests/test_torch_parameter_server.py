"""The port's parameter server: sessions over the ring, the serving
surface on the same listener, addressing, and a session between a JAX
client and a port server (the native store and ring are shared by both
packages). Every ring op and HTTP read has its own timeout."""

import socket
import threading
import time
from datetime import timedelta

import numpy as np
import pytest
import torch

import torch_one_thread  # noqa: F401

from torchft_tpu import collectives as jcol
from torchft_tpu import parameter_server as jps
from torchft_tpu_torch import collectives as tcol
from torchft_tpu_torch import serving as ts
from torchft_tpu_torch.parameter_server import ParameterServer

_T = timedelta(seconds=10)


class EchoAverageServer(ParameterServer):
    """Averages one tree with the client, twice, then ends the session."""

    @classmethod
    def new_collectives(cls) -> tcol.Collectives:
        return tcol.HostCollectives(timeout=_T, connect_timeout=_T, stripes=2)

    def forward(self, session_id, collectives) -> None:
        for _ in range(2):
            collectives.allreduce({"w": torch.full((4,), 2.0)},
                                  tcol.ReduceOp.AVG).wait()


class JaxClient(jps.ParameterServer):
    """The JAX package's session client (never serves)."""

    @classmethod
    def new_collectives(cls):
        return jcol.HostCollectives(timeout=_T, connect_timeout=_T, stripes=2)

    def forward(self, session_id, collectives):  # pragma: no cover
        raise AssertionError("client only")


def test_session_roundtrip_twice():
    server = EchoAverageServer()
    try:
        for _ in range(2):
            client = EchoAverageServer.new_session(server.address())
            for _ in range(2):
                out = client.allreduce({"w": torch.full((4,), 4.0)},
                                       tcol.ReduceOp.AVG).wait()
                assert torch.equal(out["w"], torch.full((4,), 3.0))
            client.shutdown()
    finally:
        server.shutdown()


def test_jax_client_and_port_server_complete_a_session():
    server = EchoAverageServer()
    try:
        client = JaxClient.new_session(server.address())
        for _ in range(2):
            out = client.allreduce({"w": np.full(4, 4.0, np.float32)},
                                   jcol.ReduceOp.AVG).wait()
            np.testing.assert_array_equal(out["w"], np.full(4, 3.0))
        client.shutdown()
    finally:
        server.shutdown()


class RecordingServer(EchoAverageServer):
    """Records the collectives of every session, and fails the first
    session's forward when asked."""

    def __init__(self, fail_first: bool = False) -> None:
        self.handed_out = []
        self.fail_first = fail_first
        self.done = threading.Event()
        super().__init__()

    def new_collectives(self):  # an instance's sessions: recorded
        c = EchoAverageServer.new_collectives()
        self.handed_out.append(c)
        return c

    def forward(self, session_id, collectives) -> None:
        try:
            if self.fail_first:
                self.fail_first = False
                raise RuntimeError("forward failed mid-session")
            super().forward(session_id, collectives)
        finally:
            self.done.set()


def test_session_frees_its_collectives_even_when_forward_fails():
    server = RecordingServer(fail_first=True)
    try:
        client = EchoAverageServer.new_session(server.address())
        assert server.done.wait(30)
        client.shutdown()
        (c,) = server.handed_out
        for _ in range(100):  # _handle_session's finally runs after forward
            if c._shutdown:
                break
            time.sleep(0.05)
        assert c._shutdown
    finally:
        server.shutdown()


def test_serving_surface_rides_the_listener():
    """A publish on the parameter server installs on a subscriber of
    ``serving_address()`` (dialed on loopback)."""
    server = EchoAverageServer(wire="q8", snapshot_every=2)
    try:
        base = server.serving_address().replace(
            f"{ts._url_host(ts.advertise_host())}", "[::1]")
        sub = ts.WeightSubscriber(base, device="cpu", timeout_s=20.0)
        assert not sub.poll()  # nothing published: latest = -1
        params = ts.demo_params(0, 2, 96, 0, device="cpu")
        m = server.publish(params, step=7)
        assert sub.poll() and sub.version() == 0
        assert ts.tree_digest(sub.current()[1]) == m["digest"]
        sub.close()
    finally:
        server.shutdown()


def test_address_honors_env_host(monkeypatch):
    monkeypatch.setenv("TORCHFT_PS_HOST", "ps.example.internal")
    server = EchoAverageServer()
    try:
        addr = server.address()
        assert addr.startswith("http://ps.example.internal:")
        assert addr.endswith("/new_session")
        assert server.serving_address().startswith(
            "http://ps.example.internal:")
    finally:
        server.shutdown()


def test_address_falls_back_to_hostname_and_brackets_ipv6(monkeypatch):
    monkeypatch.delenv("TORCHFT_PS_HOST", raising=False)
    server = EchoAverageServer()
    try:
        assert server.address() == (
            f"http://{socket.gethostname()}:"
            f"{server.publisher.server.port}/new_session")
        assert server.publisher.server._server.address_family == \
            socket.AF_INET6
    finally:
        server.shutdown()
    monkeypatch.setenv("TORCHFT_PS_HOST", "fd00::1234")
    server = EchoAverageServer()
    try:
        assert server.address().startswith("http://[fd00::1234]:")
    finally:
        server.shutdown()


def test_unknown_paths_reach_the_serving_router():
    import urllib.error
    import urllib.request

    server = EchoAverageServer()
    try:
        port = server.publisher.server.port
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"http://[::1]:{port}/nope", timeout=10)
        assert e.value.code == 404
        with urllib.request.urlopen(f"http://[::1]:{port}/ps/status",
                                    timeout=10) as f:
            assert b'"latest": -1' in f.read()
    finally:
        server.shutdown()
