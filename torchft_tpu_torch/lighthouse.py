"""Lighthouse CLI: ``python -m torchft_tpu_torch.lighthouse``.

The standalone quorum service over the port's native binding. Replica
groups of either package may register with it: both build the same
native control plane. Three roles (``--role``):

- ``flat`` (default): every replica group renews into this one process.
- ``root``: the same server in a hierarchical deployment: region
  lighthouses push membership digests into it and it computes the
  global quorum. ``--wal-dir`` makes it durable (a restart replays to its
  pre-crash ``quorum_id``); ``--standby --peers`` starts a passive warm
  standby that takes over when the active root stops syncing it.
- ``region``: the middle tier. It serves the manager-facing protocol
  locally, pushes digests to ``--root`` and long-polls the global quorum
  back out.

Every role serves ``GET /status.json`` beside its HTML dashboard
(:func:`fetch_status`); a region also serves its cached global quorum
as ``GET /quorum.json`` (:func:`fetch_quorum`).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import signal
import threading
import urllib.request
from typing import Optional, Sequence

from . import _native

logger = logging.getLogger(__name__)


def _fetch_json(addr: str, path: str, timeout: float) -> dict:
    if not addr.startswith("http://") and not addr.startswith("https://"):
        addr = "http://" + addr
    with urllib.request.urlopen(addr + path, timeout=timeout) as r:
        return json.loads(r.read().decode("utf-8"))


def fetch_status(addr: str, timeout: float = 5.0) -> dict:
    """A lighthouse's (any role) machine-readable status: members, lease
    deadlines, last quorum id, tier role and durability stamps. ``addr``
    is ``http://host:port`` or ``host:port``."""
    return _fetch_json(addr, "/status.json", timeout)


def fetch_quorum(addr: str, timeout: float = 5.0) -> dict:
    """A region lighthouse's cached view of the last global quorum
    (``GET /quorum.json``), read without any root traffic. ``age_ms`` is
    the time since the cache was refreshed (null before the first root
    quorum); with the root down it keeps serving while ``age_ms`` grows
    and ``root_connected`` goes false."""
    return _fetch_json(addr, "/quorum.json", timeout)


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(
        prog="torchft_tpu_torch.lighthouse",
        description="Quorum service (flat, hierarchical root, or region "
        "tier) for torchft_tpu_torch replica groups.",
    )
    parser.add_argument("--bind", default="[::]:29510")
    parser.add_argument(
        "--role", choices=("flat", "root", "region"), default="flat",
        help="flat/root: the quorum-computing service; region: aggregate "
        "local groups into digests pushed to --root",
    )
    parser.add_argument(
        "--root", default=os.environ.get("TORCHFT_LIGHTHOUSE_ROOT", ""),
        help="root lighthouse address (required for --role region; env "
        "TORCHFT_LIGHTHOUSE_ROOT)",
    )
    parser.add_argument(
        "--region-id", default="",
        help="region name shown in the root's status (default: bind addr)",
    )
    parser.add_argument(
        "--digest-interval-ms", type=int,
        default=int(os.environ.get("TORCHFT_DIGEST_INTERVAL_MS", "100")),
        help="cadence of periodic region->root digests (env "
        "TORCHFT_DIGEST_INTERVAL_MS)",
    )
    parser.add_argument("--min_replicas", type=int, default=1)
    parser.add_argument("--join_timeout_ms", type=int, default=60000)
    parser.add_argument("--quorum_tick_ms", type=int, default=100)
    parser.add_argument("--heartbeat_timeout_ms", type=int, default=5000)
    # the durable control plane (flat and root roles)
    parser.add_argument(
        "--wal-dir", default=os.environ.get("TORCHFT_LH_WAL_DIR", ""),
        help="write-ahead quorum log and snapshot directory (env "
        "TORCHFT_LH_WAL_DIR); empty = in memory only",
    )
    parser.add_argument(
        "--snapshot-every", type=int,
        default=int(os.environ.get("TORCHFT_LH_SNAPSHOT_EVERY", "0")),
        help="WAL records per snapshot (env TORCHFT_LH_SNAPSHOT_EVERY; "
        "0 = 512)",
    )
    parser.add_argument(
        "--peers", default=os.environ.get("TORCHFT_LH_PEERS", ""),
        help="comma-separated other roots of this root's failover set "
        "(env TORCHFT_LH_PEERS)",
    )
    parser.add_argument(
        "--standby", action="store_true",
        default=os.environ.get("TORCHFT_LH_STANDBY", "") in (
            "1", "on", "true"),
        help="start as a passive warm standby that takes over when the "
        "active peer stops syncing it (env TORCHFT_LH_STANDBY=1)",
    )
    parser.add_argument(
        "--takeover-ms", type=int,
        default=int(os.environ.get("TORCHFT_LH_TAKEOVER_MS", "0")),
        help="sync starvation after which a standby claims a new root "
        "epoch (env TORCHFT_LH_TAKEOVER_MS; 0 = 3000)",
    )
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    server: "_native.Lighthouse | _native.RegionLighthouse"
    if args.role == "region":
        if not args.root:
            parser.error(
                "--role region requires --root (or TORCHFT_LIGHTHOUSE_ROOT)")
        server = _native.RegionLighthouse(
            root_addr=args.root,
            region_id=args.region_id or args.bind,
            bind=args.bind,
            digest_interval_ms=args.digest_interval_ms,
            heartbeat_timeout_ms=args.heartbeat_timeout_ms,
        )
    else:
        server = _native.Lighthouse(
            bind=args.bind,
            min_replicas=args.min_replicas,
            join_timeout_ms=args.join_timeout_ms,
            quorum_tick_ms=args.quorum_tick_ms,
            heartbeat_timeout_ms=args.heartbeat_timeout_ms,
            wal_dir=args.wal_dir,
            snapshot_every=args.snapshot_every,
            peers=args.peers,
            standby=args.standby,
            takeover_ms=args.takeover_ms,
        )
    logger.info(f"{args.role} lighthouse serving on {server.address()}")

    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    stop.wait()
    server.shutdown()


if __name__ == "__main__":
    main()
