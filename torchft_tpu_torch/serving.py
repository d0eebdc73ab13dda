"""Weight-serving plane: versioned pub/sub of weight trees over a
fan-out tree of zero-copy byte-range servers.

The port of ``torchft_tpu/serving.py``. A trainer-side
:class:`WeightPublisher` publishes version-stamped weight snapshots and
deltas. Each version is encoded for the wire once, packed once into a
:class:`~.checkpointing._StreamStaging` byte-stream layout, and served as
CRC-guarded byte ranges (``X-TFT-Crc32c`` per range, 400 on a torn
republish). :class:`WeightRelay` nodes form a fan-out tree below it:
each fetches a version once, verifies it and re-serves the verbatim wire
bytes, so publisher egress per version does not grow with the
subscribers. :class:`WeightSubscriber` clients hold leases with their
serving node (a relay renews one lease upstream for its whole
population) and make staleness-bounded reads: ``age_ms`` is local
monotonic time since the last fresh contact plus the upstream's reported
age, so a partitioned relay keeps serving with an honestly growing age.

Wires (``TORCHFT_PS_WIRE``): ``q8`` (default) ships each float leaf as
``{q: int8, s: f32 scale}`` (scale = max|d|/127 floored at 1e-12, a true
divide, round half to even); ``bf16`` a round-to-nearest-even
narrowing; ``f32`` raw. On the card a whole tree encodes in one launch
pair: K1a/K1b (``quantize_q8_group``, over a zero carry the publisher
owns) or one K3 launch (``cast_bf16_group``), per 64 leaves; a q8
version decodes in one K2 launch (``dequantize_q8_group``). On the CPU
the kernels' plain versions run, and the codes, scales, bf16 words and
digests equal the JAX package's numpy path for finite leaves (a leaf
holding NaN or Inf gives codes 0 and scale ``0x7FC00000``, where numpy's
cast of a NaN to int8 is undefined).

Error feedback lives at the publisher: it tracks the ``served`` tree,
the decoded sum of everything it shipped (on the card when the weights
are), encodes each delta against it and advances it by the decoded delta
(the decode's product and the add round separately, as numpy's do), so
a subscriber that applies every delta holds the publisher's served tree
bit for bit. The manifest's ``digest`` (CRC32C over the f32 leaf bytes)
proves it at install; on a mismatch the subscriber keeps its previous
version. Late joiners catch up from the latest snapshot (every
``TORCHFT_PS_SNAPSHOT_EVERY`` versions) plus its delta chain
(``TORCHFT_PS_KEEP`` bounds what is held).

The meta pickle names this package's slot class, so a port subscriber
reads a port publisher's versions and a JAX one the JAX package's; the
data ranges, CRCs and digests of the two are equal for the same tree.
Subscribers install onto their device (``None``: the card).
"""

from __future__ import annotations

import argparse
import http.client
import json
import logging
import os
import socket
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ._device import resolve_device
from ._native import crc32c as _crc32c
from ._native import crc32c_update as _crc32c_update
from ._tree import flatten, unflatten
from .checkpointing import (
    _StreamStaging,
    load_packed_meta,
    rebuild_from_packed,
)
from .ops.quantize_kernels import (
    cast_bf16_group,
    dequantize_q8_group,
    quantize_q8_group,
)

logger: logging.Logger = logging.getLogger(__name__)

_DRIP_CHUNK = 1 << 16


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name, "").strip()
    return int(raw) if raw else default


def advertise_host() -> str:
    """The host peers should dial for this machine's serving endpoints:
    env ``TORCHFT_PS_HOST`` when set (a routable name for a machine whose
    hostname peers may not resolve), else the hostname."""
    return os.environ.get("TORCHFT_PS_HOST", "").strip() or socket.gethostname()


def _url_host(host: str) -> str:
    # bare IPv6 literals need brackets in URLs
    if ":" in host and not host.startswith("["):
        return f"[{host}]"
    return host


def wire_from_env() -> str:
    wire = os.environ.get("TORCHFT_PS_WIRE", "q8").strip().lower() or "q8"
    if wire in ("none", "raw"):
        wire = "f32"
    if wire not in ("q8", "bf16", "f32"):
        raise ValueError(f"unsupported TORCHFT_PS_WIRE: {wire!r}")
    return wire


# -- wire encode / decode ----------------------------------------------------

# the q8 encode's zero carry, per (device, element count): (zeros, scratch)
Carry = Dict[Tuple[torch.device, int], Tuple[torch.Tensor, torch.Tensor]]


def _tensor(leaf: Any) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach()
    arr = np.asarray(leaf)
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(np.ascontiguousarray(arr))


def _as_f32(leaf: Any) -> torch.Tensor:
    """The leaf as contiguous f32 (itself when it already is)."""
    t = _tensor(leaf)
    if not t.is_floating_point():
        raise ValueError(
            "the serving plane publishes float weight trees only; got a "
            f"leaf of {t.dtype}")
    return t.float().contiguous()


def _one_device(ts: List[torch.Tensor]) -> torch.device:
    devs = {t.device for t in ts}
    if len(devs) > 1:
        raise ValueError(f"a served tree's leaves must share a device: {devs}")
    return devs.pop() if devs else torch.device("cpu")


def _views(flat: torch.Tensor, ts: List[torch.Tensor]) -> List[torch.Tensor]:
    """Leaf-shaped views of a flat buffer laid out as ``ts``'s
    concatenation."""
    out, off = [], 0
    for t in ts:
        out.append(flat[off:off + t.numel()].view(t.shape))
        off += t.numel()
    return out


def encode_tree(tree: Any, wire: str, carry: Optional[Carry] = None) -> Any:
    """Encodes a float tree for the serving wire: ``q8`` leaves become
    ``{"q": int8, "s": f32 0-d}`` dicts, ``bf16`` leaves the narrowed
    words, ``f32`` an f32 copy. The leaves of the result are views of one
    flat buffer per tree, on the tree's device: one K1a/K1b launch pair
    (q8) or one K3 launch (bf16) encodes every leaf. ``carry`` holds the
    q8 pair's zero carry across calls (the publisher's); without one a
    call allocates its own."""
    leaves, treedef = flatten(tree)
    ts = [_as_f32(l) for l in leaves]
    if wire == "f32":
        return unflatten(treedef, [t.clone() for t in ts])
    dev = _one_device(ts)
    n = sum(t.numel() for t in ts)
    if wire == "q8":
        if carry is None:
            carry = {}
        if (dev, n) not in carry:
            carry.clear()  # one tree signature at a time
            carry[(dev, n)] = (
                torch.zeros(n, dtype=torch.float32, device=dev),
                torch.empty(n, dtype=torch.float32, device=dev))
        zeros, scratch = carry[(dev, n)]
        codes = torch.empty(n, dtype=torch.int8, device=dev)
        scales = torch.empty(len(ts), dtype=torch.float32, device=dev)
        quantize_q8_group(ts, codes, scales, zeros, scratch)
        return unflatten(treedef, [
            {"q": q, "s": scales[k]}
            for k, q in enumerate(_views(codes, ts))])
    if wire == "bf16":
        words = torch.empty(n, dtype=torch.bfloat16, device=dev)
        cast_bf16_group(ts, words)
        return unflatten(treedef, _views(words, ts))
    raise ValueError(f"unsupported serving wire: {wire!r}")


def _is_q8_leaf(x: Any) -> bool:
    return (isinstance(x, dict) and len(x) == 2 and "q" in x and "s" in x
            and isinstance(x.get("q"), (torch.Tensor, np.ndarray)))


class _Q8:
    """A q8 leaf while a tree is flattened (not a dict, so it stays one
    leaf)."""

    def __init__(self, q: Any, s: Any) -> None:
        self.q, self.s = _tensor(q), _tensor(s)


def _mark_q8(t: Any) -> Any:
    if _is_q8_leaf(t):
        return _Q8(t["q"], t["s"])
    if isinstance(t, dict):
        return {k: _mark_q8(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return type(t)(_mark_q8(v) for v in t)
    return t


def decode_tree(enc: Any, wire: str) -> Any:
    """The exact decode of :func:`encode_tree`'s output to an f32 tree on
    its device: ``q * s`` for q8, with one K2 launch over every leaf on
    the card (a NaN scale decodes to ``0x7FC00000``), the exact widening
    for bf16, the leaves themselves for f32."""
    if wire == "q8":
        pairs, treedef = flatten(_mark_q8(enc))
        dev = _one_device([p.q for p in pairs])
        counts = [p.q.numel() for p in pairs]
        codes = (torch.cat([p.q.reshape(-1) for p in pairs]) if pairs
                 else torch.empty(0, dtype=torch.int8, device=dev))
        scales = (torch.stack([p.s.reshape(()).float() for p in pairs])
                  if pairs else torch.empty(0, device=dev))
        out = torch.empty(sum(counts), dtype=torch.float32, device=dev)
        dequantize_q8_group(codes, scales, counts, out)
        return unflatten(treedef, _views(out, [p.q for p in pairs]))
    if wire == "bf16":
        leaves, treedef = flatten(enc)
        return unflatten(treedef, [_tensor(l).float() for l in leaves])
    if wire == "f32":
        leaves, treedef = flatten(enc)
        return unflatten(treedef, [_as_f32(l) for l in leaves])
    raise ValueError(f"unsupported serving wire: {wire!r}")


def tree_digest(tree: Any) -> str:
    """CRC32C over the f32 bytes of every leaf in flatten order: the
    install-time proof that a subscriber's tree is the publisher's served
    tree bit for bit, the JAX package's function over the same values.
    Card leaves are read back into one pinned buffer first (one
    synchronisation)."""
    ts = [_as_f32(leaf) for leaf in flatten(tree)[0]]
    card = [t for t in ts if t.is_cuda]
    if card:
        host = torch.empty(sum(t.numel() for t in card), dtype=torch.float32,
                           pin_memory=True)
        at, down = 0, []
        for t in card:
            host[at:at + t.numel()].copy_(t.reshape(-1), non_blocking=True)
            down.append(host[at:at + t.numel()])
            at += t.numel()
        torch.cuda.synchronize(card[0].device)
        it = iter(down)
        ts = [next(it) if t.is_cuda else t for t in ts]
    state = _crc32c(b"")
    for t in ts:
        state = _crc32c_update(
            state, memoryview(t.reshape(-1).numpy().view(np.uint8)))
    return f"{state:08x}"


def _tree_zip(fn: Callable[[Any, Any], Any], a: Any, b: Any) -> Any:
    la, treedef = flatten(a)
    lb, def_b = flatten(b)
    if treedef != def_b:
        raise ValueError("served trees differ in structure")
    return unflatten(treedef, [fn(x, y) for x, y in zip(la, lb)])


def _tree_sub(a: Any, b: Any) -> Any:
    return _tree_zip(lambda x, y: x - y, a, b)


def _tree_add(a: Any, b: Any) -> Any:
    return _tree_zip(lambda x, y: x + y, a, b)


def _tree_f32(tree: Any) -> Any:
    leaves, treedef = flatten(tree)
    return unflatten(treedef, [_as_f32(l) for l in leaves])


def _tree_nbytes(tree: Any) -> int:
    return sum(t.numel() * t.element_size()
               for t in (_tensor(l) for l in flatten(tree)[0]))


# -- version store -----------------------------------------------------------


class _BytesSource:
    """A relay-held version: the verbatim wire bytes as fetched from
    upstream (CRC already verified). Ranges are memoryview slices — the
    re-serve path never copies, never re-encodes."""

    def __init__(self, payload: bytes) -> None:
        self._view = memoryview(payload)
        self.total = len(payload)

    def write_range(self, wfile: Any, begin: int, end: int) -> None:
        wfile.write(self._view[begin:end])

    def range_crc32c(self, begin: int, end: int) -> int:
        return _crc32c(self._view[begin:end])


class _HeldVersion:
    """One servable version: manifest (JSON-safe dict), the packed-stream
    meta blob, and a range source (a live zero-copy staging on the
    publisher, verbatim cached bytes on a relay)."""

    def __init__(self, manifest: Dict[str, Any], meta: bytes, source: Any) -> None:
        self.manifest = manifest
        self.meta = meta
        self.source = source


class _VersionStore:
    """Versioned map of held versions with long-poll support. Eviction
    keeps the latest snapshot and everything after it (the late-joiner
    catch-up chain must stay intact); older versions are dropped oldest
    first once more than ``keep`` are held."""

    def __init__(self, keep: int) -> None:
        self._keep = max(int(keep), 1)
        self._versions: Dict[int, _HeldVersion] = {}
        self._lock = threading.RLock()
        self._cv = threading.Condition(self._lock)
        self._latest = -1
        self._latest_snapshot = -1

    def install(self, held: _HeldVersion) -> None:
        v = int(held.manifest["version"])
        with self._cv:
            self._versions[v] = held
            self._latest = max(self._latest, v)
            if held.manifest["kind"] == "snapshot":
                self._latest_snapshot = max(self._latest_snapshot, v)
            for old in sorted(self._versions):
                if len(self._versions) <= self._keep:
                    break
                if old >= self._latest_snapshot:
                    break
                del self._versions[old]
            self._cv.notify_all()

    def clear(self) -> None:
        """Forget everything (upstream republished from scratch — a
        restarted publisher); waiters wake and re-plan."""
        with self._cv:
            self._versions.clear()
            self._latest = -1
            self._latest_snapshot = -1
            self._cv.notify_all()

    def get(self, version: int) -> Optional[_HeldVersion]:
        with self._lock:
            return self._versions.get(version)

    def latest(self) -> int:
        with self._lock:
            return self._latest

    def latest_snapshot(self) -> int:
        with self._lock:
            return self._latest_snapshot

    def manifests(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [
                self._versions[v].manifest for v in sorted(self._versions)
            ]

    def wait_newer(self, after: int, timeout_s: float) -> int:
        deadline = time.monotonic() + timeout_s
        with self._cv:
            while self._latest <= after:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cv.wait(remaining)
            return self._latest


# -- serving node (the HTTP surface shared by publisher and relay) -----------


class _ServingNode:
    """Shared server-side state: the version store, lease table, egress
    accounting, and the freshness provider the ``age_ms`` fields come
    from. The publisher and every relay each own one."""

    def __init__(self, role: str, keep: int, lease_ttl_ms: int) -> None:
        self.role = role
        self.store = _VersionStore(keep=keep)
        self.lease_ttl_ms = lease_ttl_ms
        self._leases: Dict[str, Tuple[float, int]] = {}
        self._lock = threading.Lock()
        self.counters: Dict[str, int] = {
            "egress_bytes": 0,
            "ranges_served": 0,
            "meta_served": 0,
            "status_served": 0,
            "nonce_rejects": 0,
            "lease_renews": 0,
            "publishes": 0,
            "syncs": 0,
            "upstream_errors": 0,
        }
        # Relays override this with their partition-honest computation;
        # a publisher IS the source of truth, so its view is never stale.
        self.age_ms: Callable[[], int] = (
            lambda: 0 if self.store.latest() >= 0 else -1
        )
        self.drip_ms = _env_int("TORCHFT_PS_DRIP_MS", 0)

    def incr(self, key: str, amount: int = 1) -> None:
        with self._lock:
            self.counters[key] = self.counters.get(key, 0) + amount

    def renew_lease(self, lease_id: str, ttl_ms: int, subs: int) -> int:
        """Register/renew one lease entry. ``subs`` is the BATCH weight:
        a relay covers its whole downstream population with one entry
        (the LeaseClient batched-renewal shape on the serving wire).
        Returns the fleet-wide subscriber total after pruning."""
        now = time.monotonic()
        with self._lock:
            self._leases[lease_id] = (
                now + max(ttl_ms, 1) / 1000.0,
                max(int(subs), 0),
            )
            self.counters["lease_renews"] += 1
            return self._prune_leases_locked(now)

    def drop_lease(self, lease_id: str) -> None:
        with self._lock:
            self._leases.pop(lease_id, None)

    def _prune_leases_locked(self, now: float) -> int:
        for lid in [l for l, (dl, _) in self._leases.items() if dl < now]:
            del self._leases[lid]
        return sum(subs for _, subs in self._leases.values())

    def lease_totals(self) -> Tuple[int, int]:
        """(live lease entries, fleet subscriber total) after pruning."""
        with self._lock:
            total = self._prune_leases_locked(time.monotonic())
            return len(self._leases), total

    def status(self) -> Dict[str, Any]:
        leases, subscribers = self.lease_totals()
        latest = self.store.latest()
        held = self.store.get(latest)
        with self._lock:
            counters = dict(self.counters)
        return {
            "role": self.role,
            "latest": latest,
            "latest_snapshot": self.store.latest_snapshot(),
            "latest_nonce": held.manifest["nonce"] if held else "",
            "age_ms": int(self.age_ms()),
            "leases": leases,
            "subscribers": subscribers,
            "counters": counters,
        }

    def listing(self) -> Dict[str, Any]:
        out = self.status()
        out["versions"] = self.store.manifests()
        return out


def _make_handler(
    node: _ServingNode,
    extra_get: Optional[Callable[[BaseHTTPRequestHandler, str], bool]],
) -> type:
    """The /ps/* GET router. ``extra_get`` lets a host server graft
    additional routes (the parameter-server compat shim) onto the same
    listener; it runs first and returns True when it consumed the
    request."""

    class RequestHandler(BaseHTTPRequestHandler):
        def _send_json(self, obj: Dict[str, Any]) -> None:
            data = (json.dumps(obj) + "\n").encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)
            node.incr("egress_bytes", len(data))

        def _held_for(
            self, version: int, nonce: str
        ) -> Optional[_HeldVersion]:
            held = node.store.get(version)
            if held is None:
                self.send_error(
                    404, f"unknown or evicted version {version}"
                )
                return None
            if nonce != held.manifest["nonce"]:
                # Torn republish: the version number was reused by a
                # different publish (publisher restart). Serving the
                # bytes would mix two payloads in one subscriber buffer:
                # 400, and the client re-plans (the heal stream's
                # stale-seq contract).
                node.incr("nonce_rejects")
                self.send_error(
                    400,
                    f"stale publish: version {version} serving nonce "
                    f"{held.manifest['nonce']}, range asked for {nonce}",
                )
                return None
            return held

        def do_GET(self) -> None:  # noqa: N802 - stdlib naming
            if extra_get is not None and extra_get(self, self.path):
                return
            parsed = urllib.parse.urlsplit(self.path)
            parts = [p for p in parsed.path.split("/") if p]
            query = urllib.parse.parse_qs(parsed.query)
            try:
                self._route(parts, query)
            except (BrokenPipeError, ConnectionResetError):
                pass  # client went away mid-body; nothing to answer

        def _route(
            self, parts: List[str], query: Dict[str, List[str]]
        ) -> None:
            if not parts or parts[0] != "ps":
                self.send_error(404, f"invalid path: {self.path}")
                return
            if parts[1:] == ["status"]:
                node.incr("status_served")
                self._send_json(node.status())
                return
            if parts[1:] == ["versions"]:
                node.incr("status_served")
                self._send_json(node.listing())
                return
            if len(parts) == 3 and parts[1] == "wait":
                after = int(parts[2])
                timeout_ms = int(query.get("timeout_ms", ["1000"])[0])
                node.store.wait_newer(
                    after, min(max(timeout_ms, 0), 60_000) / 1000.0
                )
                node.incr("status_served")
                self._send_json(node.status())
                return
            if len(parts) == 3 and parts[1] == "manifest":
                held = node.store.get(int(parts[2]))
                if held is None:
                    self.send_error(404, f"unknown version {parts[2]}")
                    return
                self._send_json(held.manifest)
                return
            if len(parts) == 4 and parts[1] == "meta":
                held = self._held_for(int(parts[2]), parts[3])
                if held is None:
                    return
                self.send_response(200)
                self.send_header(
                    "Content-Type", "application/octet-stream"
                )
                self.send_header("Content-Length", str(len(held.meta)))
                self.end_headers()
                self.wfile.write(held.meta)
                node.incr("meta_served")
                node.incr("egress_bytes", len(held.meta))
                return
            if len(parts) == 6 and parts[1] == "range":
                self._serve_range(
                    int(parts[2]), int(parts[3]), int(parts[4]), parts[5]
                )
                return
            if len(parts) == 5 and parts[1] == "lease":
                lease_id, ttl_ms, subs = (
                    parts[2], int(parts[3]), int(parts[4])
                )
                total = node.renew_lease(lease_id, ttl_ms, subs)
                self._send_json(
                    {"ok": True, "ttl_ms": ttl_ms, "subscribers": total}
                )
                return
            self.send_error(404, f"invalid path: {self.path}")

        def _serve_range(
            self, version: int, i: int, n: int, nonce: str
        ) -> None:
            if n < 1 or not (0 <= i < n):
                self.send_error(404, f"bad range part {i}/{n}")
                return
            held = self._held_for(version, nonce)
            if held is None:
                return
            source = held.source
            begin = source.total * i // n
            end = source.total * (i + 1) // n
            self.send_response(200)
            self.send_header("Content-Type", "application/octet-stream")
            self.send_header("Content-Length", str(end - begin))
            # Per-range CRC32C, same polynomial as the ring frames and
            # the heal stream: the subscriber verifies BEFORE the bytes
            # can reach an install.
            self.send_header(
                "X-TFT-Crc32c", f"{source.range_crc32c(begin, end):08x}"
            )
            self.end_headers()
            if node.drip_ms > 0:
                # Test/bench throttle: stream the body in small chunks
                # so a publisher killed mid-range dies mid-body.
                pos = begin
                while pos < end:
                    nxt = min(pos + _DRIP_CHUNK, end)
                    source.write_range(self.wfile, pos, nxt)
                    self.wfile.flush()
                    pos = nxt
                    time.sleep(node.drip_ms / 1000.0)
            else:
                source.write_range(self.wfile, begin, end)
            node.incr("ranges_served")
            node.incr("egress_bytes", end - begin)

        def log_message(self, format: str, *args: object) -> None:
            logger.debug(f"serving[{node.role}]: {format % args}")

    return RequestHandler


class ServingServer:
    """IPv6 threaded HTTP server bound to a :class:`_ServingNode`. The
    same listener shape as the checkpoint server (dual-stack ``::``,
    daemon handler threads, deep accept queue for subscriber stampedes)."""

    def __init__(
        self,
        node: _ServingNode,
        port: int = 0,
        extra_get: Optional[
            Callable[[BaseHTTPRequestHandler, str], bool]
        ] = None,
    ) -> None:
        class _Server(ThreadingHTTPServer):
            address_family = socket.AF_INET6
            request_queue_size = 1024
            daemon_threads = True

        self._server = _Server(("::", port), _make_handler(node, extra_get))
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            daemon=True,
            name=f"serving_{node.role}",
        )
        self._thread.start()

    @property
    def port(self) -> int:
        return int(self._server.socket.getsockname()[1])

    def address(self) -> str:
        """Advertised base URL (``TORCHFT_PS_HOST`` honored)."""
        return f"http://{_url_host(advertise_host())}:{self.port}"

    def local_address(self) -> str:
        """Loopback base URL for same-host composition (tests, benches)."""
        return f"http://[::1]:{self.port}"

    def shutdown(self) -> None:
        self._server.shutdown()
        self._thread.join()
        self._server.server_close()


# -- client-side wire --------------------------------------------------------


class WireDetection(Exception):
    """A fetch aborted by an integrity/consistency check BEFORE any
    state was touched: ``kind`` names the detector (``crc``, ``nonce``,
    ``short``, ``gone``, ``digest``, ``gap``). Zero torn installs is the
    plane's invariant; these are the detections that enforce it."""

    def __init__(self, kind: str, detail: str) -> None:
        super().__init__(f"{kind}: {detail}")
        self.kind = kind


def _http_json(url: str, timeout_s: float) -> Dict[str, Any]:
    with urllib.request.urlopen(url, timeout=timeout_s) as f:
        return json.load(f)


def _http_bytes(url: str, timeout_s: float, verify_crc: bool) -> bytes:
    """GET a body, enforcing Content-Length (a publisher killed mid-range
    yields a SHORT body, never a silently truncated install) and the
    per-range ``X-TFT-Crc32c`` header when asked. 400 means the serving
    side refused a stale nonce — surfaced as a ``nonce`` detection."""
    try:
        with urllib.request.urlopen(url, timeout=timeout_s) as f:
            expected = int(f.headers.get("Content-Length", "-1"))
            body = f.read()
            if expected >= 0 and len(body) != expected:
                raise WireDetection(
                    "short",
                    f"{url}: body {len(body)} of {expected} bytes",
                )
            if verify_crc:
                crc_hdr = f.headers.get("X-TFT-Crc32c")
                if crc_hdr is None or int(crc_hdr, 16) != _crc32c(body):
                    raise WireDetection(
                        "crc", f"{url}: range CRC mismatch"
                    )
            return body
    except urllib.error.HTTPError as e:
        if e.code == 400:
            raise WireDetection("nonce", f"{url}: {e.reason}") from e
        if e.code == 404:
            raise WireDetection("gone", f"{url}: {e.reason}") from e
        raise
    except (OSError, http.client.HTTPException) as e:
        # a connection torn mid-body (publisher SIGKILL) lands here;
        # URLError/timeout are OSError subclasses
        raise WireDetection("short", f"{url}: {e}") from e


def _fetch_version(
    base: str,
    manifest: Dict[str, Any],
    streams: int,
    timeout_s: float,
) -> Tuple[bytes, bytearray]:
    """Fetch one version's (meta, payload) from a serving node, nonce-
    pinned, range-CRC-verified, then full-payload-CRC-verified against
    the manifest. Any failure raises :class:`WireDetection` with nothing
    partially applied. The payload stays a (writable) bytearray: the
    rebuild's leaves are views of it."""
    v = int(manifest["version"])
    nonce = manifest["nonce"]
    meta = _http_bytes(
        f"{base}/ps/meta/{v}/{nonce}", timeout_s, verify_crc=False
    )
    if len(meta) != int(manifest["meta_len"]):
        raise WireDetection(
            "short", f"meta for v{v}: {len(meta)} of {manifest['meta_len']}"
        )
    total = int(manifest["total"])
    n = max(1, min(int(streams), 64))
    payload = bytearray(total)
    pos = 0
    for i in range(n):
        chunk = _http_bytes(
            f"{base}/ps/range/{v}/{i}/{n}/{nonce}",
            timeout_s,
            verify_crc=True,
        )
        payload[pos:pos + len(chunk)] = chunk
        pos += len(chunk)
    if pos != total:
        raise WireDetection("short", f"v{v}: {pos} of {total} bytes")
    if _crc32c(memoryview(payload)) != int(manifest["crc"], 16):
        raise WireDetection("crc", f"v{v}: full payload CRC mismatch")
    return meta, payload


def _catch_up_plan(
    have: int, manifests: Dict[int, Dict[str, Any]]
) -> List[int]:
    """Versions to fetch, ascending, to go from ``have`` to the latest
    held version: the pure delta chain when every link is present, else
    latest snapshot + its delta suffix (the late-joiner path). Raises a
    ``gap`` detection when neither chain closes — the caller keeps its
    state and retries after the next publish/sync."""
    if not manifests:
        return []
    latest = max(manifests)
    if have >= latest:
        return []
    deltas = list(range(have + 1, latest + 1))
    if have >= 0 and all(
        v in manifests and manifests[v]["kind"] == "delta" for v in deltas
    ):
        return deltas
    snapshots = [
        v for v, m in manifests.items() if m["kind"] == "snapshot"
    ]
    if not snapshots:
        raise WireDetection(
            "gap", f"no snapshot held; have={have} latest={latest}"
        )
    s = max(snapshots)
    chain = list(range(s + 1, latest + 1))
    if not all(
        v in manifests and manifests[v]["kind"] == "delta" for v in chain
    ):
        raise WireDetection(
            "gap", f"broken delta chain after snapshot {s}"
        )
    return [s] + chain


# -- publisher ---------------------------------------------------------------


def _sync(tree: Any) -> None:
    """Waits for the card work queued on a tree's device (a timing
    boundary of the publish split)."""
    for leaf in flatten(tree)[0]:
        if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
            torch.cuda.synchronize(leaf.device)
            return


class WeightPublisher:
    """The root of the fan-out tree: encodes and packs each published
    version once and serves it to its direct children (relays, or
    subscribers in a flat deployment). Publish cost is paid per version,
    never per subscriber.

    Error feedback: ``_served`` is the f32 tree a subscriber holds after
    applying every shipped payload, on the device of the published
    weights. A delta is encoded against it and it advances by the decoded
    delta, so quantization error feeds into the next delta instead of
    accumulating downstream, and the manifest's ``digest`` of
    ``_served`` is what a correct install must hash to. With the weights
    on the card the encode, the decode and the add run there and only
    the wire bytes (and the digest's read-back of ``_served``) cross to
    the host. ``last_publish`` splits the last publish's seconds:
    ``wait_s`` (the card work queued before the publish, which writes
    the weights), ``encode_s`` (the encode, decode and add, waited for),
    ``staging_s`` (the wire bytes to the host), ``crc_s``,
    ``digest_s``."""

    def __init__(
        self,
        port: int = 0,
        wire: Optional[str] = None,
        snapshot_every: Optional[int] = None,
        keep: Optional[int] = None,
        lease_ttl_ms: Optional[int] = None,
        extra_get: Optional[
            Callable[[BaseHTTPRequestHandler, str], bool]
        ] = None,
    ) -> None:
        self.wire = wire if wire is not None else wire_from_env()
        if self.wire not in ("q8", "bf16", "f32"):
            raise ValueError(f"unsupported serving wire: {self.wire!r}")
        self.snapshot_every = max(
            snapshot_every
            if snapshot_every is not None
            else _env_int("TORCHFT_PS_SNAPSHOT_EVERY", 8),
            1,
        )
        self.node = _ServingNode(
            role="publisher",
            keep=(
                keep if keep is not None else _env_int("TORCHFT_PS_KEEP", 16)
            ),
            lease_ttl_ms=(
                lease_ttl_ms
                if lease_ttl_ms is not None
                else _env_int("TORCHFT_PS_LEASE_TTL_MS", 10_000)
            ),
        )
        self.server = ServingServer(self.node, port=port, extra_get=extra_get)
        self._publish_lock = threading.Lock()
        self._served: Any = None
        self._carry: Carry = {}
        self._next_version = 0
        self.last_publish: Optional[Dict[str, Any]] = None
        logger.info(
            f"WeightPublisher serving on {self.server.address()} "
            f"(wire={self.wire}, snapshot_every={self.snapshot_every})"
        )

    def address(self) -> str:
        return self.server.address()

    def publish(self, params: Any, step: Optional[int] = None) -> Dict[str, Any]:
        """Publishes one version of ``params`` (a float tree of tensors on
        one device, or numpy arrays) and returns its manifest."""
        with self._publish_lock:
            tw = time.perf_counter()
            _sync(params)  # the card work that writes the weights
            t0 = time.perf_counter()
            version = self._next_version
            snapshot = (
                self._served is None or version % self.snapshot_every == 0
            )
            if snapshot:
                f32_nbytes = _tree_nbytes(params)
                enc = encode_tree(params, self.wire, self._carry)
                self._served = decode_tree(enc, self.wire)
            else:
                current = _tree_f32(params)
                f32_nbytes = _tree_nbytes(current)
                enc = encode_tree(
                    _tree_sub(current, self._served), self.wire, self._carry
                )
                self._served = _tree_add(
                    self._served, decode_tree(enc, self.wire)
                )
            _sync(self._served)
            t1 = time.perf_counter()
            staging = _StreamStaging(enc, wire=None)
            t2 = time.perf_counter()
            crc = staging.range_crc32c(0, staging.total)
            t3 = time.perf_counter()
            digest = tree_digest(self._served)
            t4 = time.perf_counter()
            manifest = {
                "version": version,
                "kind": "snapshot" if snapshot else "delta",
                "base": None if snapshot else version - 1,
                "wire": self.wire,
                "step": step,
                "total": staging.total,
                "meta_len": len(staging.meta),
                "f32_nbytes": f32_nbytes,
                "crc": f"{crc:08x}",
                "digest": digest,
                "nonce": uuid.uuid4().hex[:16],
            }
            self.node.store.install(
                _HeldVersion(manifest, staging.meta, staging)
            )
            self._next_version = version + 1
            self.node.incr("publishes")
            self.last_publish = {
                "version": version, "kind": manifest["kind"],
                "wire_bytes": staging.total, "wait_s": t0 - tw,
                "encode_s": t1 - t0,
                "staging_s": t2 - t1, "crc_s": t3 - t2, "digest_s": t4 - t3,
                "total_s": time.perf_counter() - tw,
            }
            return manifest

    def served(self) -> Any:
        """The served tree: what a subscriber holds at the latest
        version."""
        return self._served

    def status(self) -> Dict[str, Any]:
        return self.node.status()

    def shutdown(self) -> None:
        self.server.shutdown()


def publish_on_commit(
    manager: Any,
    publisher: WeightPublisher,
    params_fn: Callable[[], Any],
    every: int = 1,
) -> None:
    """Publishes at commit: rides ``Manager.add_commit_hook`` so every
    ``every``-th committed step publishes ``params_fn()`` stamped with
    the step. Commit hooks must not raise; a failed publish is logged by
    the manager and the trainer goes on."""
    every = max(int(every), 1)

    def _hook(step: int, quorum_id: int, committed: bool) -> None:
        if committed and step % every == 0:
            publisher.publish(params_fn(), step=step)

    manager.add_commit_hook(_hook)


# -- relay -------------------------------------------------------------------


class WeightRelay:
    """One interior node of the fan-out tree: syncs versions from its
    upstream (publisher or another relay) as VERBATIM wire bytes —
    CRC-verified on the way in, then re-served as zero-copy memoryview
    ranges; the payload is never decoded, re-encoded or re-pickled —
    and fronts its own subscriber population. It renews ONE batched
    lease upstream covering that whole population, so lease traffic at
    the publisher scales with the tree's fan-out, not the fleet size.

    Honest staleness: ``age_ms`` is local monotonic time since the last
    successful upstream sync PLUS the age the upstream reported then —
    no cross-host clocks involved. A partitioned relay (or a dead
    publisher) keeps serving its held versions while that age grows."""

    def __init__(
        self,
        upstream: str,
        port: int = 0,
        keep: Optional[int] = None,
        lease_ttl_ms: Optional[int] = None,
        streams: Optional[int] = None,
        poll_timeout_ms: int = 1000,
        timeout_s: float = 20.0,
        name: Optional[str] = None,
    ) -> None:
        self.upstream = upstream.rstrip("/")
        self.streams = (
            streams if streams is not None else _env_int("TORCHFT_PS_STREAMS", 2)
        )
        self._poll_timeout_ms = poll_timeout_ms
        self._timeout_s = timeout_s
        self.name = name or f"relay-{uuid.uuid4().hex[:8]}"
        self.node = _ServingNode(
            role="relay",
            keep=(
                keep if keep is not None else _env_int("TORCHFT_PS_KEEP", 16)
            ),
            lease_ttl_ms=(
                lease_ttl_ms
                if lease_ttl_ms is not None
                else _env_int("TORCHFT_PS_LEASE_TTL_MS", 10_000)
            ),
        )
        self.node.age_ms = self._age_ms
        self.server = ServingServer(self.node, port=port)
        self._fresh_lock = threading.Lock()
        self._fresh_mono: Optional[float] = None
        self._fresh_upstream_age = 0
        self._partitioned = False
        self._lease_due = 0.0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def address(self) -> str:
        return self.server.address()

    def _age_ms(self) -> int:
        with self._fresh_lock:
            if self._fresh_mono is None:
                return -1
            return int(
                (time.monotonic() - self._fresh_mono) * 1000.0
                + max(self._fresh_upstream_age, 0)
            )

    def set_partitioned(self, flag: bool) -> None:
        """Fault seam: a partitioned relay stops reaching upstream (every
        sync attempt fails as if the link were cut) but keeps serving;
        its ``age_ms`` grows honestly until the partition lifts."""
        self._partitioned = flag

    def sync_once(self) -> bool:
        """One upstream sync: list versions, fetch what is missing
        (verbatim, integrity-checked), refresh the freshness clock.
        Returns True when anything new was installed. Raises
        :class:`WireDetection`/:class:`OSError` on an unreachable or
        torn upstream — the caller's loop counts and retries."""
        if self._partitioned:
            raise WireDetection("gone", f"{self.name}: partitioned")
        listing = _http_json(
            f"{self.upstream}/ps/versions", self._timeout_s
        )
        manifests = {
            int(m["version"]): m for m in listing.get("versions", [])
        }
        mine = self.node.store.latest()
        up_latest = int(listing.get("latest", -1))
        if manifests and mine >= 0:
            held = self.node.store.get(mine)
            stale_nonce = (
                mine in manifests
                and held is not None
                and manifests[mine]["nonce"] != held.manifest["nonce"]
            )
            if up_latest < mine or stale_nonce:
                # Upstream republished from scratch (publisher restart):
                # our chain no longer extends theirs. Drop and resync
                # from their snapshot; downstream subscribers re-plan
                # the same way off our listing.
                logger.info(
                    f"{self.name}: upstream regression "
                    f"(mine={mine}, upstream={up_latest}); resyncing"
                )
                self.node.store.clear()
                mine = -1
        progressed = False
        for v in _catch_up_plan(mine, manifests):
            m = manifests[v]
            meta, payload = _fetch_version(
                self.upstream, m, self.streams, self._timeout_s
            )
            self.node.store.install(
                _HeldVersion(dict(m), meta, _BytesSource(payload))
            )
            self.node.incr("syncs")
            progressed = True
        if self.node.store.latest() >= up_latest:
            with self._fresh_lock:
                self._fresh_mono = time.monotonic()
                self._fresh_upstream_age = int(listing.get("age_ms", 0))
        return progressed

    def _renew_upstream_lease(self) -> None:
        now = time.monotonic()
        if now < self._lease_due:
            return
        ttl = self.node.lease_ttl_ms
        _, subs = self.node.lease_totals()
        _http_json(
            f"{self.upstream}/ps/lease/{self.name}/{ttl}/{max(subs, 1)}",
            self._timeout_s,
        )
        self._lease_due = now + ttl / 3000.0

    def _run(self) -> None:
        backoff = 0.05
        while not self._stop.is_set():
            try:
                self.sync_once()
                self._renew_upstream_lease()
                backoff = 0.05
                # idle until upstream advances past what we hold
                _http_json(
                    f"{self.upstream}/ps/wait/{self.node.store.latest()}"
                    f"?timeout_ms={self._poll_timeout_ms}",
                    self._timeout_s + self._poll_timeout_ms / 1000.0,
                )
            except (WireDetection, OSError, ValueError) as e:
                self.node.incr("upstream_errors")
                logger.debug(f"{self.name}: upstream sync failed: {e}")
                self._stop.wait(backoff)
                backoff = min(backoff * 2, 0.5)

    def start(self) -> "WeightRelay":
        self._thread = threading.Thread(
            target=self._run, daemon=True, name=self.name
        )
        self._thread.start()
        return self

    def shutdown(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
        self.server.shutdown()


# -- subscriber --------------------------------------------------------------


class StaleWeightsError(Exception):
    """A staleness-bounded read found weights older than the caller's
    ``max_age_ms`` bound (or no weights at all)."""


class WeightSubscriber:
    """One inference client: holds a lease with its serving node, polls
    for new versions, and installs them on its device (``None``: the
    card) through the integrity ladder: range CRC, then the payload's
    CRC, the nonce pinning, and the tree digest after decoding. An
    install is all or nothing: every detection leaves the installed
    version untouched, so a publisher dying mid-range cannot corrupt
    this subscriber.

    Reads are staleness-bounded: :meth:`current` returns ``(version,
    tree, age_ms)`` and raises :class:`StaleWeightsError` when the honest
    age exceeds the caller's bound. ``last_install`` splits the last
    install's seconds: ``fetch_s`` (the bytes, CRC-checked), ``decode_s``
    (the rebuild on the device and the decode) and ``digest_s``."""

    def __init__(
        self,
        address: str,
        streams: Optional[int] = None,
        lease_ttl_ms: Optional[int] = None,
        max_age_ms: Optional[int] = None,
        timeout_s: float = 20.0,
        name: Optional[str] = None,
        device: Optional[Union[str, torch.device]] = None,
    ) -> None:
        self.base = address.rstrip("/")
        self.device = resolve_device(device)
        self.streams = (
            streams if streams is not None else _env_int("TORCHFT_PS_STREAMS", 2)
        )
        self.lease_ttl_ms = (
            lease_ttl_ms
            if lease_ttl_ms is not None
            else _env_int("TORCHFT_PS_LEASE_TTL_MS", 10_000)
        )
        self.max_age_ms = (
            max_age_ms
            if max_age_ms is not None
            else _env_int("TORCHFT_PS_MAX_AGE_MS", 0)
        )
        self._timeout_s = timeout_s
        self.name = name or f"sub-{uuid.uuid4().hex[:8]}"
        self._lock = threading.Lock()
        self._tree: Any = None
        self._version = -1
        self._fresh_mono: Optional[float] = None
        self._fresh_upstream_age = 0
        self._lease_due = 0.0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.last_install: Optional[Dict[str, Any]] = None
        self.stats: Dict[str, int] = {
            "bytes_fetched": 0,
            "installs": 0,
            "snapshot_installs": 0,
            "delta_installs": 0,
            "catch_up_deltas": 0,
            "torn_installs": 0,
            "detect_crc": 0,
            "detect_nonce": 0,
            "detect_short": 0,
            "detect_gone": 0,
            "detect_digest": 0,
            "detect_gap": 0,
        }

    # -- read side --

    def version(self) -> int:
        with self._lock:
            return self._version

    def age_ms(self) -> int:
        with self._lock:
            if self._fresh_mono is None:
                return -1
            return int(
                (time.monotonic() - self._fresh_mono) * 1000.0
                + max(self._fresh_upstream_age, 0)
            )

    def current(
        self, max_age_ms: Optional[int] = None
    ) -> Tuple[int, Any, int]:
        """``(version, f32 tree, age_ms)`` of the installed weights.
        ``max_age_ms`` (default the instance/env bound; 0 = unbounded)
        raises :class:`StaleWeightsError` on an over-age read."""
        bound = self.max_age_ms if max_age_ms is None else max_age_ms
        with self._lock:
            if self._tree is None:
                raise StaleWeightsError(f"{self.name}: no weights installed")
            age = (
                int(
                    (time.monotonic() - self._fresh_mono) * 1000.0
                    + max(self._fresh_upstream_age, 0)
                )
                if self._fresh_mono is not None
                else -1
            )
            if bound and (age < 0 or age > bound):
                raise StaleWeightsError(
                    f"{self.name}: weights age {age}ms exceeds bound "
                    f"{bound}ms (version {self._version})"
                )
            return self._version, self._tree, age

    # -- sync side --

    def _renew_lease(self) -> None:
        now = time.monotonic()
        if now < self._lease_due:
            return
        try:
            _http_json(
                f"{self.base}/ps/lease/{self.name}/{self.lease_ttl_ms}/1",
                self._timeout_s,
            )
        except (OSError, ValueError):
            pass  # advisory; the next poll retries
        self._lease_due = now + self.lease_ttl_ms / 3000.0

    def _detect(self, kind: str) -> None:
        self.stats[f"detect_{kind}"] = self.stats.get(f"detect_{kind}", 0) + 1

    def poll(self, wait_timeout_ms: int = 0) -> bool:
        """One sync step: renew the lease, check the serving node, catch
        up to its latest version. ``wait_timeout_ms`` long-polls when
        already current. Returns True when a new version was installed;
        False on no news or on a detected and averted failure (state
        untouched either way)."""
        self._renew_lease()
        have = self.version()
        try:
            if wait_timeout_ms > 0:
                listing = _http_json(
                    f"{self.base}/ps/wait/{have}"
                    f"?timeout_ms={wait_timeout_ms}",
                    self._timeout_s + wait_timeout_ms / 1000.0,
                )
                if int(listing.get("latest", -1)) > have:
                    listing = _http_json(
                        f"{self.base}/ps/versions", self._timeout_s
                    )
            else:
                listing = _http_json(
                    f"{self.base}/ps/versions", self._timeout_s
                )
        except (OSError, ValueError):
            self._detect("gone")
            return False
        manifests = {
            int(m["version"]): m for m in listing.get("versions", [])
        }
        up_latest = int(listing.get("latest", -1))
        if have >= 0 and up_latest < have:
            # the publisher restarted below our version: our chain is
            # dead; restart from its snapshot (state stays until the new
            # chain fully verifies)
            have = -1
        try:
            plan = _catch_up_plan(have, manifests)
        except WireDetection as e:
            self._detect(e.kind)
            return False
        if not plan:
            if up_latest >= 0 and up_latest == self.version():
                with self._lock:
                    self._fresh_mono = time.monotonic()
                    self._fresh_upstream_age = int(
                        listing.get("age_ms", 0)
                    )
            return False
        # Build the candidate tree off to the side; swap only after the
        # whole chain decodes and the final digest matches.
        if manifests[plan[0]]["kind"] == "snapshot":
            work = None
        else:
            with self._lock:
                work = self._tree
        fetched_bytes = 0
        fetch_s = decode_s = 0.0
        try:
            for v in plan:
                m = manifests[v]
                t0 = time.perf_counter()
                meta_raw, payload = _fetch_version(
                    self.base, m, self.streams, self._timeout_s
                )
                t1 = time.perf_counter()
                fetched_bytes += len(meta_raw) + len(payload)
                enc = rebuild_from_packed(load_packed_meta(meta_raw), payload,
                                          device=self.device)
                dec = decode_tree(enc, m["wire"])
                if m["kind"] == "snapshot":
                    work = dec
                else:
                    if work is None:
                        raise WireDetection(
                            "gap", f"delta v{v} with no base installed"
                        )
                    work = _tree_add(work, dec)
                _sync(work)
                fetch_s += t1 - t0
                decode_s += time.perf_counter() - t1
        except WireDetection as e:
            self._detect(e.kind)
            return False
        final = manifests[plan[-1]]
        t2 = time.perf_counter()
        digest_ok = tree_digest(work) == final["digest"]
        digest_s = time.perf_counter() - t2
        if not digest_ok:
            # the ladder caught nothing but the end state is wrong: a
            # torn install averted at the last gate
            self._detect("digest")
            return False
        deltas = sum(1 for v in plan if manifests[v]["kind"] == "delta")
        with self._lock:
            self._tree = work
            self._version = int(final["version"])
            self._fresh_mono = time.monotonic()
            self._fresh_upstream_age = int(listing.get("age_ms", 0))
            self.stats["bytes_fetched"] += fetched_bytes
            self.stats["installs"] += 1
            if manifests[plan[0]]["kind"] == "snapshot":
                self.stats["snapshot_installs"] += 1
            if deltas:
                self.stats["delta_installs"] += 1
                self.stats["catch_up_deltas"] += deltas
            self.last_install = {
                "version": self._version, "versions": len(plan),
                "bytes": fetched_bytes, "fetch_s": fetch_s,
                "decode_s": decode_s, "digest_s": digest_s,
            }
        return True

    def wait_version(self, version: int, timeout_s: float) -> bool:
        """Polls until at least ``version`` is installed; True on
        success within the deadline."""
        deadline = time.monotonic() + timeout_s
        while self.version() < version:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return False
            self.poll(wait_timeout_ms=int(min(remaining, 1.0) * 1000))
        return True

    def _run(self, poll_ms: int) -> None:
        while not self._stop.is_set():
            try:
                self.poll(wait_timeout_ms=poll_ms)
            except Exception as e:  # noqa: BLE001 - keep the loop alive
                logger.debug(f"{self.name}: poll failed: {e}")
                self._stop.wait(0.05)

    def start(self, poll_ms: int = 1000) -> "WeightSubscriber":
        self._thread = threading.Thread(
            target=self._run, args=(poll_ms,), daemon=True, name=self.name
        )
        self._thread.start()
        return self

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
        try:
            _http_json(
                f"{self.base}/ps/lease/{self.name}/1/0", self._timeout_s
            )
        except (OSError, ValueError):
            pass


# -- demo publisher process ------------------------------------------------------


def demo_params(seed: int, leaves: int, elems: int, version: int,
                device: Optional[Union[str, torch.device]] = None) -> Any:
    """A deterministic weight tree on ``device`` (``None``: the card): a
    seeded base walked by a seeded step, the JAX package's values, so
    any process can recompute version ``v``'s tree."""
    base_rng = np.random.default_rng(seed)
    step_rng = np.random.default_rng(seed + 1)
    device = resolve_device(device)
    tree = {}
    for i in range(leaves):
        base = base_rng.standard_normal(elems).astype(np.float32)
        step = step_rng.standard_normal(elems).astype(np.float32)
        tree[f"layer{i}"] = torch.from_numpy(
            base + np.float32(0.01 * version) * step).to(device)
    return tree


def main(argv: Optional[List[str]] = None) -> int:
    """``python -m torchft_tpu_torch.serving``: a standalone demo
    publisher of :func:`demo_params` versions (on the card unless
    ``--device cpu``)."""
    parser = argparse.ArgumentParser(
        description="torchft_tpu_torch demo weight publisher")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--wire", default=None, choices=("q8", "bf16", "f32"))
    parser.add_argument("--leaves", type=int, default=4)
    parser.add_argument("--elems", type=int, default=16384)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--versions", type=int, default=0,
                        help="publishes before lingering (0 = forever)")
    parser.add_argument("--publish-every-ms", type=int, default=250)
    parser.add_argument("--snapshot-every", type=int, default=None)
    parser.add_argument("--keep", type=int, default=None)
    parser.add_argument("--device", default=None,
                        help="where the weights live (default: the card)")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    device = resolve_device(args.device)
    pub = WeightPublisher(
        port=args.port,
        wire=args.wire,
        snapshot_every=args.snapshot_every,
        keep=args.keep,
    )
    print(f"serving {pub.address()} port={pub.server.port}", flush=True)
    version = 0
    try:
        while True:
            if args.versions <= 0 or version < args.versions:
                pub.publish(
                    demo_params(args.seed, args.leaves, args.elems, version,
                                device),
                    step=version,
                )
                version += 1
            time.sleep(args.publish_every_ms / 1000.0)
    except KeyboardInterrupt:
        pass
    finally:
        pub.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
