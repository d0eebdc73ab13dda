"""The port's comm-plan collectives against the JAX package's.

Three contracts:

- the port's ``_plan_groups`` reproduces the JAX one (and so native
  ``plan_build``) over mixed signatures, so prepacked group layouts agree;
- the device pack (here on the CPU: the kernels' plain versions) and the
  host pack (the native plan's own cast/EF) produce bit-identical results;
- a mixed ring — one ``torchft_tpu`` member with numpy leaves, one port
  member with torch tensors — commits bit-identical results on the f32,
  bf16 and q8ef wires.

Plus the port-side fix for ROADMAP F1: an f32 NaN with a high mantissa
(0x7FFFFFFF, the card's canonical NaN) survives the bf16 wire.
"""

import threading
from concurrent.futures import ThreadPoolExecutor
from datetime import timedelta

import ml_dtypes
import numpy as np
import pytest
import torch

import torch_one_thread  # noqa: F401

from torchft_tpu import collectives as jcol
from torchft_tpu._native import Store
from torchft_tpu_torch import collectives as tcol

_NP = {
    "f32": (np.float32, torch.float32),
    "f64": (np.float64, torch.float64),
    "i32": (np.int32, torch.int32),
    "i64": (np.int64, torch.int64),
    "bf16": (ml_dtypes.bfloat16, torch.bfloat16),
    "f16": (np.float16, torch.float16),
}


@pytest.fixture
def store():
    s = Store()
    yield s
    s.shutdown()


def _configure(cols, store, prefix):
    addr = f"{store.address()}/{prefix}"
    with ThreadPoolExecutor(max_workers=len(cols)) as ex:
        for f in [
            ex.submit(c.configure, addr, r, len(cols)) for r, c in enumerate(cols)
        ]:
            f.result(timeout=60)


def _run_all(cols, fn):
    results = [None] * len(cols)
    errors = []

    def run(r):
        try:
            results[r] = fn(r, cols[r])
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=run, args=(r,)) for r in range(len(cols))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    if errors:
        raise errors[0]
    return results


def _port_ring(store, world, prefix):
    cols = [
        tcol.HostCollectives(timeout=timedelta(seconds=20), stripes=2)
        for _ in range(world)
    ]
    _configure(cols, store, prefix)
    return cols


def _grads(world, seed, step=0):
    """Per-member gradient trees (numpy), uneven sizes, with a nested
    list like the transformer's ``blocks``."""
    rng = np.random.default_rng(seed * 100 + step)
    return [
        {
            "w": rng.standard_normal(10007).astype(np.float32),
            "blocks": [
                {"b": rng.standard_normal((7, 13)).astype(np.float32) * 5},
                {"b": rng.standard_normal((7, 13)).astype(np.float32)},
            ],
            "s": rng.standard_normal(3).astype(np.float32) * 1e-3,
        }
        for _ in range(world)
    ]


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_torch(v) for v in tree]
    return torch.from_numpy(np.ascontiguousarray(tree))


def _leaf_bytes(tree):
    """Leaf bytes in jax.tree_util order (sorted keys)."""
    if isinstance(tree, dict):
        return [b for k in sorted(tree) for b in _leaf_bytes(tree[k])]
    if isinstance(tree, list):
        return [b for v in tree for b in _leaf_bytes(v)]
    if isinstance(tree, torch.Tensor):
        if tree.dtype == torch.bfloat16:
            return [tree.view(torch.int16).numpy().tobytes()]
        return [tree.numpy().tobytes()]
    return [np.asarray(tree).tobytes()]


def _tree_plus_zero(tree):
    if isinstance(tree, dict):
        return {k: _tree_plus_zero(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_plus_zero(v) for v in tree]
    return tree + 0.0


class TestPlanGroups:
    SIGS = [
        ["f32", "f32", "f32"],
        ["f32", "bf16", "f32", "i32"],
        ["i64", "f32", "f64", "bf16", "f32", "i64"],
        ["bf16", "bf16", "f32"],
        ["f64", "i32", "i64"],
        ["f32", "f16"],
    ]

    @pytest.mark.parametrize("wire", [None, "bf16", "q8", "q8ef"])
    @pytest.mark.parametrize("sig", range(len(SIGS)))
    def test_matches_jax_plan_groups(self, wire, sig):
        names = self.SIGS[sig]
        shapes = [(i + 1, 3) for i in range(len(names))]
        jsig = [(s, np.dtype(_NP[n][0])) for s, n in zip(shapes, names)]
        tsig = [(s, _NP[n][1]) for s, n in zip(shapes, names)]
        try:
            want = jcol._plan_groups(jsig, wire)
        except KeyError:
            with pytest.raises(KeyError):
                tcol._plan_groups(tsig, wire)
            return
        got = tcol._plan_groups(tsig, wire)
        assert [idxs for _, idxs in got] == [idxs for _, idxs in want]
        names_of = {_NP[n][1]: np.dtype(_NP[n][0]) for n in _NP}
        assert [names_of[g] for g, _ in got] == [g for g, _ in want]


class TestDevicePackMatchesHostPack:
    @pytest.mark.parametrize("wire", ["q8ef", "bf16", None])
    @pytest.mark.parametrize("world", [1, 2])
    def test_bit_identical(self, store, wire, world):
        cols = _port_ring(store, world, f"dp_{wire}_{world}")
        try:
            for step in range(3):  # several steps: the q8ef carry advances
                grads = _grads(world, seed=1, step=step)
                out = {}
                for dp in (False, True):
                    out[dp] = _run_all(
                        cols,
                        lambda r, c: c.plan_allreduce(
                            _to_torch(grads[r]), tcol.ReduceOp.AVG,
                            wire=wire, device_pack=dp,
                        ).wait(),
                    )
                if world == 1 and wire == "q8ef":
                    # A one-member ring never re-encodes: the host EF's
                    # float code keeps the sign of a zero (-0.0) that an
                    # int8 code cannot carry (+0.0). Ring members of two
                    # or more re-quantize per hop, which kills the sign
                    # identically; here signed zeros are normalized.
                    out = {dp: [_tree_plus_zero(t) for t in o]
                           for dp, o in out.items()}
                for r in range(world):
                    assert _leaf_bytes(out[True][r]) == _leaf_bytes(out[False][r])
                    assert _leaf_bytes(out[True][r]) == _leaf_bytes(out[True][0])
        finally:
            for c in cols:
                c.shutdown()

    def test_device_pack_advances_and_resets_carry(self, store):
        cols = _port_ring(store, 1, "dp_reset")
        try:
            c = cols[0]
            g = _to_torch(_grads(1, seed=2)[0])
            first = _leaf_bytes(c.plan_allreduce(g, wire="q8ef", device_pack=True).wait())
            second = _leaf_bytes(c.plan_allreduce(g, wire="q8ef", device_pack=True).wait())
            assert first != second  # the carry moved the second step
            c.plan_reset_feedback()
            again = _leaf_bytes(c.plan_allreduce(g, wire="q8ef", device_pack=True).wait())
            assert again == first
        finally:
            cols[0].shutdown()


class TestMixedRing:
    @pytest.mark.parametrize("port_device_pack", [False, True])
    @pytest.mark.parametrize("wire", [None, "bf16", "q8ef"])
    def test_jax_and_port_members_agree(self, store, wire, port_device_pack):
        jax_member = jcol.HostCollectives(timeout=timedelta(seconds=20), stripes=2)
        port_member = tcol.HostCollectives(timeout=timedelta(seconds=20), stripes=2)
        cols = [jax_member, port_member]
        _configure(cols, store, f"mixed_{wire}_{port_device_pack}")
        try:
            for step in range(3):
                grads = _grads(2, seed=3, step=step)

                def run(r, c):
                    if r == 0:
                        return c.plan_allreduce(
                            grads[0], jcol.ReduceOp.AVG, wire=wire,
                            device_pack=False,
                        ).wait()
                    return c.plan_allreduce(
                        _to_torch(grads[1]), tcol.ReduceOp.AVG, wire=wire,
                        device_pack=port_device_pack,
                    ).wait()

                jax_out, port_out = _run_all(cols, run)
                assert _leaf_bytes(jax_out) == _leaf_bytes(port_out), (
                    f"step {step}: mixed ring desynced on wire {wire}"
                )
        finally:
            for c in cols:
                c.shutdown()


class TestBf16WireNaN:
    """ROADMAP F1: the native bf16 pack turns 0x7FFFFFFF into -0.0; the
    port's host pack canonicalises NaN first, and its device pack casts
    through K3, so every member sees NaN."""

    @pytest.mark.parametrize("device_pack", [False, True])
    def test_high_mantissa_nan_survives(self, store, device_pack):
        cols = _port_ring(store, 2, f"f1_{device_pack}")
        try:
            def run(r, c):
                x = torch.ones(9)
                if r == 1:
                    x.view(torch.int32)[4] = 0x7FFFFFFF
                return c.plan_allreduce(
                    {"g": x}, tcol.ReduceOp.AVG, wire="bf16",
                    device_pack=device_pack,
                ).wait()

            for out in _run_all(cols, run):
                g = out["g"]
                assert torch.isnan(g[4])
                assert torch.equal(g[:4], torch.ones(4))
        finally:
            for c in cols:
                c.shutdown()


class TestRingKnobs:
    """ROADMAP F7: the inter-region stripe count and the ring's CRC32C
    trailer ride the negotiated fingerprint in both packages, so a JAX
    member and a port member with either knob set share a ring."""

    KNOBS = {"stripes_inter": ("TORCHFT_HC_STRIPES_INTER", "3"),
             "wire_crc": ("TORCHFT_WIRE_CRC", "1")}

    @pytest.mark.parametrize("wire", [None, "q8ef"])
    @pytest.mark.parametrize("knob", sorted(KNOBS))
    def test_mixed_ring_commits_bit_identical(self, store, monkeypatch,
                                              knob, wire):
        monkeypatch.setenv(*self.KNOBS[knob])
        cols = [jcol.HostCollectives(timeout=timedelta(seconds=20), stripes=2),
                tcol.HostCollectives(timeout=timedelta(seconds=20), stripes=2)]
        assert cols[1]._stripes_inter == cols[0]._stripes_inter
        assert cols[1]._wire_crc == cols[0]._wire_crc
        addr = f"{store.address()}/f7_{knob}_{wire}"
        regions = ["r0", "r1"]  # two regions: the inter ring is built
        with ThreadPoolExecutor(max_workers=2) as ex:
            for f in [ex.submit(c.configure, addr, r, 2, regions)
                      for r, c in enumerate(cols)]:
                f.result(timeout=60)
        try:
            if knob == "wire_crc":
                assert tcol._lib.tft_hc_wire_crc(cols[1]._handle) == 1
            assert cols[1].hier_capable() and cols[0].hier_capable()
            for step in range(2):
                grads = _grads(2, seed=7, step=step)

                def run(r, c):
                    if r == 0:
                        return c.plan_allreduce(
                            grads[0], jcol.ReduceOp.AVG, wire=wire,
                            device_pack=False).wait()
                    return c.plan_allreduce(
                        _to_torch(grads[1]), tcol.ReduceOp.AVG, wire=wire,
                        device_pack=True).wait()

                jax_out, port_out = _run_all(cols, run)
                assert _leaf_bytes(jax_out) == _leaf_bytes(port_out)
            hier = _run_all(cols, lambda r, c: c.allreduce_hier(
                grads[r] if r == 0 else _to_torch(grads[r]),
                jcol.ReduceOp.AVG if r == 0 else tcol.ReduceOp.AVG).wait())
            assert _leaf_bytes(hier[0]) == _leaf_bytes(hier[1])
        finally:
            for c in cols:
                c.shutdown()

    @pytest.mark.parametrize("knob", sorted(KNOBS))
    def test_fingerprint_tokens_match_the_jax_package(self, knob):
        env, val = self.KNOBS[knob]
        inter = int(val) if knob == "stripes_inter" else 2
        crc = knob == "wire_crc"
        fp = tcol._fingerprint(2, inter, ["r0", "r1"], [], 4, 4 << 20, crc)
        assert fp == f"4:{4 << 20}:2:{inter}:r0,r1" + (":crc1" if crc else "")

    def test_crc_mismatch_fails_configure(self, store):
        # (the connect timeouts bound rank 0's wait for its lost peer)
        cols = [jcol.HostCollectives(timeout=timedelta(seconds=20),
                                     connect_timeout=timedelta(seconds=2),
                                     stripes=2, wire_crc=False),
                tcol.HostCollectives(timeout=timedelta(seconds=20),
                                     connect_timeout=timedelta(seconds=2),
                                     stripes=2, wire_crc=True)]
        try:
            addr = f"{store.address()}/f7_mismatch"
            with ThreadPoolExecutor(max_workers=2) as ex:
                futs = [ex.submit(c.configure, addr, r, 2)
                        for r, c in enumerate(cols)]
                with pytest.raises(RuntimeError, match="mismatch"):
                    futs[1].result(timeout=60)
        finally:
            for c in cols:
                c.shutdown()


def test_plain_allreduce_matches_jax(store):
    jax_member = jcol.HostCollectives(timeout=timedelta(seconds=20), stripes=2)
    port_member = tcol.HostCollectives(timeout=timedelta(seconds=20), stripes=2)
    cols = [jax_member, port_member]
    _configure(cols, store, "plain")
    try:
        grads = _grads(2, seed=4)

        def run(r, c):
            tree = grads[0] if r == 0 else _to_torch(grads[1])
            return c.allreduce(tree, jcol.ReduceOp.AVG if r == 0
                               else tcol.ReduceOp.AVG).wait()

        jax_out, port_out = _run_all(cols, run)
        assert _leaf_bytes(jax_out) == _leaf_bytes(port_out)
    finally:
        for c in cols:
            c.shutdown()


def test_device_pack_refuses_unsupported_leaves(store):
    cols = _port_ring(store, 1, "refuse")
    try:
        work = cols[0].plan_allreduce(
            {"i": torch.arange(4, dtype=torch.int32)}, wire="q8ef",
            device_pack=True,
        )
        with pytest.raises(ValueError):
            work.wait()
    finally:
        cols[0].shutdown()
