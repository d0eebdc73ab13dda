"""Fault-tolerant parameter server on the serving plane.

The port of ``torchft_tpu/parameter_server.py``. ``GET /new_session``
mints a uuid-prefixed store namespace, answers with it, and then runs
``forward(session_id, collectives)`` on the handler thread over a
two-member ring (server rank 0, client rank 1). The HTTP listener is a
:class:`~.serving.ServingServer`, so the same port also serves the
``/ps/*`` weight-distribution surface through an owned
:class:`~.serving.WeightPublisher`: ``publish()`` hands a weight tree to
subscribers while clients open sessions on ``/new_session``.

Addressing: peers may not resolve this machine's bare hostname, so the
advertised URLs honor env ``TORCHFT_PS_HOST`` (else the hostname), with
IPv6 literals bracketed.
"""

from __future__ import annotations

import json
import logging
import socket
import urllib.request
import uuid
from abc import ABC, abstractmethod
from http.server import BaseHTTPRequestHandler
from typing import Any, Dict, Optional

from . import _native
from .collectives import Collectives
from .serving import WeightPublisher, advertise_host, _url_host

logger: logging.Logger = logging.getLogger(__name__)


class ParameterServer(ABC):
    """Threaded parameter server over the reconfigurable collectives,
    fronted by the serving plane's HTTP listener."""

    def __init__(
        self,
        port: int = 0,
        wire: Optional[str] = None,
        snapshot_every: Optional[int] = None,
        keep: Optional[int] = None,
    ) -> None:
        self.store = _native.Store()
        # The serving tier owns the listener; /new_session rides it. The
        # publisher starts empty: /ps/* answers (latest = -1) before the
        # first publish.
        self.publisher = WeightPublisher(
            port=port,
            wire=wire,
            snapshot_every=snapshot_every,
            keep=keep,
            extra_get=self._handle_legacy_get,
        )
        self._server = self.publisher.server
        logger.info(f"Started ParameterServer on {self.address()}...")

    def _handle_legacy_get(
        self, handler: BaseHTTPRequestHandler, path: str
    ) -> bool:
        """The session API: consumes ``/new_session`` and leaves every
        other path (the /ps/* surface) to the serving router. Runs on the
        handler thread, which the session then keeps."""
        if path.split("?")[0] != "/new_session":
            return False
        try:
            session_id = str(uuid.uuid4())
            store_addr = f"{self.store.address()}/session/{session_id}"
            logger.info(f"creating new session {session_id}")

            data = (
                json.dumps(
                    {"session_id": session_id, "store_addr": store_addr}
                )
                + "\n"
            ).encode()
            handler.send_response(200)
            handler.send_header("Content-Type", "application/json")
            handler.send_header("Content-Length", str(len(data)))
            handler.end_headers()
            handler.wfile.write(data)
            # End the response's half of the connection now, so the
            # client reads the JSON whole, then keep this handler thread
            # for the session (the server closes the socket after it).
            handler.wfile.flush()
            handler.connection.shutdown(socket.SHUT_WR)

            self._handle_session(session_id, store_addr)
        except Exception:
            logger.exception(
                f"got exception in request handler for {path}"
            )
            raise
        return True

    def address(self) -> str:
        """HTTP address for creating sessions:
        ``http://host:port/new_session``. The host honors env
        ``TORCHFT_PS_HOST`` (peers may not resolve the bare hostname);
        IPv6 literals are bracketed."""
        port = self._server.port
        return f"http://{_url_host(advertise_host())}:{port}/new_session"

    def serving_address(self) -> str:
        """Base URL of the pub/sub serving surface (``/ps/*``) — what
        relays and subscribers dial."""
        return self._server.address()

    def publish(self, params: Any, step: Optional[int] = None) -> Dict[str, Any]:
        """Publish one weight version into the serving plane (see
        :meth:`.serving.WeightPublisher.publish`)."""
        return self.publisher.publish(params, step=step)

    def shutdown(self) -> None:
        self.publisher.shutdown()
        self.store.shutdown()

    @classmethod
    @abstractmethod
    def new_collectives(cls) -> Collectives:
        """A fresh, unconfigured Collectives for one session (both sides)."""

    @classmethod
    def new_session(cls, address: str) -> Collectives:
        """Client side: opens a session, returns collectives configured with
        the server (server rank 0, client rank 1)."""
        with urllib.request.urlopen(address) as f:
            data = json.load(f)
        session_id = data["session_id"]
        store_addr = data["store_addr"]
        logger.info(f"connecting to session {session_id} at {store_addr}")

        collectives = cls.new_collectives()
        collectives.configure(store_addr, rank=1, world_size=2)
        return collectives

    def _handle_session(self, session_id: str, store_addr: str) -> None:
        collectives = self.new_collectives()
        try:
            collectives.configure(store_addr, rank=0, world_size=2)
            self.forward(session_id, collectives)
        finally:
            # A finished or failed session frees its collectives (ring
            # sockets + op thread) immediately, not at GC time.
            collectives.shutdown()

    @abstractmethod
    def forward(self, session_id: str, collectives: Collectives) -> None:
        """Runs once per session on a dedicated thread; loop inside for
        multiple operations. Errors free the collectives; the client then
        opens a new session."""
