"""The port's two-tier (topology-aware) data plane against the JAX
package's.

- Mixed rings: JAX and port ``HostCollectives`` members on a two-region
  layout and on a three-tier (region + shared-memory host) layout run
  ``plan_allreduce(hier=True)`` on the wires None, bf16 and q8ef over
  three steps (the q8ef carry advances at the region leaders), bit-identical
  across members and with an all-JAX ring on the same data.
- The capability rules (no map, one region, partial labels: flat only; a
  hosts-only cohort: capable), the loopback-TCP host tier against shm bit
  for bit, ``plan_reset_feedback`` on the two-tier carry, and the shm
  segments' lifetime with both native libraries in one process.
- ROADMAP F1 on the two-tier bf16 wire: the port canonicalises NaN before
  the native pack; the reference keeps the defect.
- The region and host labels flow from quorum to data plane through the
  port's ``Manager``; an unlabeled cohort latches ``hier=True``.
- The slice as a whole: two port groups and two JAX groups train the
  small LM with ``PipelinedDDP(compress="q8", transport="plan",
  hier=True)``.
"""

import threading
from concurrent.futures import ThreadPoolExecutor
from datetime import timedelta

import numpy as np
import pytest
import torch

import torch_one_thread  # noqa: F401
from torchft_tpu import collectives as jcol
from torchft_tpu._native import Store
from torchft_tpu._native import _lib as jlib
from torchft_tpu_torch import _native as tnative
from torchft_tpu_torch import collectives as tcol

_T = timedelta(seconds=20)

LAYOUTS = {
    "two_region": (["a", "a", "b", "b"], None),
    "three_tier": (["a", "a", "b", "b"], ["h0", "h0", "h1", "h1"]),
}


@pytest.fixture
def store():
    s = Store()
    yield s
    s.shutdown()


def _ring(store, members, prefix, regions, hosts=None):
    """``members``: "j"/"t" per rank (JAX / port), configured together."""
    cols = [
        (jcol if m == "j" else tcol).HostCollectives(timeout=_T, stripes=2)
        for m in members
    ]
    addr = f"{store.address()}/{prefix}"
    with ThreadPoolExecutor(max_workers=len(cols)) as ex:
        for f in [ex.submit(c.configure, addr, r, len(cols), regions, hosts)
                  for r, c in enumerate(cols)]:
            f.result(timeout=60)
    return cols


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


def _shutdown(cols):
    for c in cols:
        c.shutdown()


def _trees(world, seed, step):
    rng = np.random.default_rng(seed * 100 + step)
    return [
        {
            "w": (rng.standard_normal(3001) * (r + 1)).astype(np.float32),
            "blocks": [{"b": rng.standard_normal((7, 13)).astype(np.float32)}],
        }
        for r in range(world)
    ]


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_torch(v) for v in tree]
    return torch.from_numpy(np.ascontiguousarray(tree))


def _bytes(tree):
    """Leaf bytes in jax.tree_util order (sorted keys)."""
    if isinstance(tree, dict):
        return b"".join(_bytes(tree[k]) for k in sorted(tree))
    if isinstance(tree, list):
        return b"".join(_bytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numpy().tobytes()
    return np.asarray(tree).tobytes()


def _plan_hier(trees, wire, op="avg"):
    def run(r, c):
        port = isinstance(c, tcol.HostCollectives)
        mod = tcol if port else jcol
        tree = _to_torch(trees[r]) if port else trees[r]
        return c.plan_allreduce(
            tree, mod.ReduceOp.AVG if op == "avg" else mod.ReduceOp.SUM,
            wire=wire, hier=True,
        ).wait()

    return run


class TestMixedHierRing:
    @pytest.mark.parametrize("wire", [None, "bf16", "q8ef"])
    @pytest.mark.parametrize("layout", sorted(LAYOUTS))
    def test_bit_identical_with_all_jax_ring(self, store, layout, wire):
        regions, hosts = LAYOUTS[layout]
        mixed = _ring(store, "jtjt", f"mx_{layout}_{wire}", regions, hosts)
        ref = _ring(store, "jjjj", f"rf_{layout}_{wire}", regions, hosts)
        try:
            assert all(c.hier_capable() for c in mixed + ref)
            if hosts:
                assert [c.host_tier_transport() for c in mixed] == ["shm"] * 4
            for step in range(3):  # the q8ef carries advance at the leaders
                trees = _trees(4, seed=1, step=step)
                got = _run_all(mixed, _plan_hier(trees, wire))
                want = _run_all(ref, _plan_hier(trees, wire))
                for r in range(4):
                    assert _bytes(got[r]) == _bytes(want[0]), (
                        f"step {step} rank {r}: the mixed ring diverged")
                    assert _bytes(want[r]) == _bytes(want[0])
        finally:
            _shutdown(mixed + ref)

    def test_bulk_allreduce_hier_matches_jax(self, store):
        regions, hosts = LAYOUTS["three_tier"]
        cols = _ring(store, "tjtj", "bulk", regions, hosts)
        try:
            trees = _trees(4, seed=2, step=0)
            for wire in (None, "bf16", "q8"):
                def run(r, c, wire=wire):
                    port = isinstance(c, tcol.HostCollectives)
                    tree = _to_torch(trees[r]) if port else trees[r]
                    return c.allreduce_hier(
                        tree, (tcol if port else jcol).ReduceOp.AVG, wire=wire
                    ).wait()

                out = _run_all(cols, run)
                for r in range(4):
                    assert _bytes(out[r]) == _bytes(out[1]), wire
        finally:
            _shutdown(cols)


class TestHierRules:
    @pytest.mark.parametrize("regions,hosts", [
        (None, None),             # no map
        (["same", "same"], None),  # one region
        (["a", ""], None),         # partially labeled
        (None, ["h0", ""]),        # partially host-labeled
    ], ids=["no_map", "one_region", "partial_regions", "partial_hosts"])
    def test_flat_only(self, store, regions, hosts):
        cols = _ring(store, "tt", f"flat_{regions}_{hosts}", regions, hosts)
        try:
            assert not any(c.hier_capable() for c in cols)
            with pytest.raises(RuntimeError, match="hier-capable"):
                _run_all(cols, lambda r, c: c.plan_allreduce(
                    torch.ones(8), hier=True).wait())
            with pytest.raises(RuntimeError):
                _run_all(cols, lambda r, c: c.allreduce_hier(
                    torch.ones(8)).wait())
        finally:
            _shutdown(cols)

    def test_hosts_only_cohort_is_capable(self, store):
        cols = _ring(store, "ttt", "honly", None, ["h0", "h0", "h1"])
        try:
            assert all(c.hier_capable() for c in cols)
            assert [c.host_tier_transport() for c in cols] == [
                "shm", "shm", "none"]
            out = _run_all(cols, lambda r, c: c.plan_allreduce(
                torch.full((64,), float(r + 1)), hier=True).wait())
            for o in out:
                assert torch.equal(o, torch.full((64,), 6.0))
        finally:
            _shutdown(cols)

    def test_tcp_host_tier_matches_shm(self, store, monkeypatch):
        regions, hosts = LAYOUTS["three_tier"]
        trees = _trees(4, seed=3, step=0)
        out = {}
        for shm in ("1", "0"):
            monkeypatch.setenv("TORCHFT_HC_SHM", shm)
            cols = _ring(store, "tttt", f"tcp{shm}", regions, hosts)
            try:
                assert [c.host_tier_transport() for c in cols] == [
                    "shm" if shm == "1" else "tcp"] * 4
                out[shm] = [_bytes(o) for o in _run_all(
                    cols, _plan_hier(trees, "q8ef"))]
            finally:
                _shutdown(cols)
        assert out["0"] == out["1"]
        assert len(set(out["1"])) == 1

    def test_reset_feedback_covers_hier_carry(self, store):
        cols = _ring(store, "tt", "rst", ["a", "b"])
        try:
            tree = {"x": torch.linspace(-3, 5, 50)}

            def sync(r, c):
                return c.plan_allreduce(tree, tcol.ReduceOp.SUM, wire="q8ef",
                                        hier=True).wait()["x"].clone()

            first = _run_all(cols, sync)
            second = _run_all(cols, sync)  # advances the leaders' carries
            assert not torch.equal(first[0], second[0])
            for c in cols:
                c.plan_reset_feedback()
            again = _run_all(cols, sync)
            assert torch.equal(again[0], first[0])
            assert torch.equal(again[1], first[1])
        finally:
            _shutdown(cols)


class TestShmSegments:
    def test_two_libraries_do_not_collide_and_release_unlinks(self, store):
        """JAX and port members co-hosted in one process: each library
        creates its own ranks' segments (names carry the configure
        generation's store prefix and the ranks, so they cannot collide),
        and shutdown's release unlinks them."""
        jbase = int(jlib.tft_shm_live_count())
        tbase = int(tnative._lib.tft_shm_live_count())
        cols = _ring(store, "jtjt", "seg", None, ["h0"] * 4)
        try:
            # 2 members x 2 stripes x (1 tx + 1 rx) handles per library
            assert int(jlib.tft_shm_live_count()) == jbase + 8
            assert int(tnative._lib.tft_shm_live_count()) == tbase + 8
            out = _run_all(cols, _plan_hier(_trees(4, seed=4, step=0), None))
            assert len({_bytes(o) for o in out}) == 1
        finally:
            _shutdown(cols)
        assert int(jlib.tft_shm_live_count()) == jbase
        assert int(tnative._lib.tft_shm_live_count()) == tbase


class TestBf16HierNaN:
    """ROADMAP F1 on the two-tier schedule: the native bf16 rounding
    carry turns 0x7FFFFFFF into -0.0 and 0xFFFFFFFF into +0.0 at the
    leader's inter hop. The port canonicalises NaN (sign | 0x7FC00000)
    before the native pack, so the bf16 words are 0x7FC0 and 0xFFC0; the
    reference keeps the defect."""

    @staticmethod
    def _poisoned(r):
        x = torch.ones(9)
        if r == 1:
            x.view(torch.int32)[4] = 0x7FFFFFFF
            x.view(torch.int32)[5] = -1  # 0xFFFFFFFF
        return x

    @pytest.mark.parametrize("bulk", [False, True], ids=["plan", "bulk"])
    def test_port_canonicalises(self, store, bulk):
        cols = _ring(store, "tt", f"nan_{bulk}", ["a", "b"])
        try:
            def run(r, c):
                x = {"g": self._poisoned(r)}
                if bulk:
                    return c.allreduce_hier(x, wire="bf16").wait()
                return c.plan_allreduce(x, wire="bf16", hier=True).wait()

            for out in _run_all(cols, run):
                words = (out["g"].view(torch.int32) >> 16) & 0xFFFF
                assert int(words[4]) == 0x7FC0
                assert int(words[5]) == 0xFFC0
                assert torch.equal(out["g"][:4], torch.full((4,), 2.0))
        finally:
            _shutdown(cols)

    def test_reference_keeps_the_defect(self, store):
        cols = _ring(store, "jj", "nan_ref", ["a", "b"])
        try:
            out = _run_all(cols, lambda r, c: c.plan_allreduce(
                {"g": self._poisoned(r).numpy()}, wire="bf16",
                hier=True).wait())
            assert not np.isnan(np.asarray(out[0]["g"])[4])
        finally:
            _shutdown(cols)


# ---- the Manager: labels from quorum to data plane ----


def _port_manager(lighthouse, idx, store, hc, region=None, host_label=None,
                  min_replicas=2, box=None):
    import torchft_tpu_torch as tft

    box = box if box is not None else {"params": 0}
    return tft.Manager(
        collectives=hc, load_state_dict=lambda s: box.update(s),
        state_dict=lambda: dict(box), min_replica_size=min_replicas,
        rank=0, world_size=1, store_addr=store.address(),
        lighthouse_addr=lighthouse.address(), replica_id=f"hier{idx}",
        region=region, host_label=host_label, timeout=_T, quorum_timeout=_T,
        connect_timeout=_T, device="cpu",
    )


def _two_groups(fn, **labels):
    """Runs ``fn(manager, hc, idx)`` in two port replica groups at once;
    ``labels``: per-group lists of ``region`` / ``host_label``."""
    import torchft_tpu_torch as tft

    lighthouse = tft.Lighthouse(min_replicas=2, join_timeout_ms=100)
    results, errors = {}, []
    barrier = threading.Barrier(2)

    def replica(idx):
        store = tnative.Store()
        hc = tcol.HostCollectives(timeout=_T)
        manager = None
        try:
            manager = _port_manager(
                lighthouse, idx, store, hc,
                **{k: v[idx] for k, v in labels.items()})
            barrier.wait(timeout=20)
            results[idx] = fn(manager, hc, idx)
        except Exception as e:  # noqa: BLE001
            errors.append((idx, e))
        finally:
            if manager is not None:
                manager.shutdown()
            hc.shutdown()
            store.shutdown()

    threads = [threading.Thread(target=replica, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=90)
    lighthouse.shutdown()
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    return results


class TestManagerPlumbing:
    def test_region_labels_flow_to_two_tier_plane(self):
        def step(manager, hc, idx):
            # the first step is group 1's initial weight sync (it heals and
            # contributes zeros); the second averages both
            for _ in range(2):
                manager.start_quorum()
                out = manager.allreduce_hier(
                    {"g": torch.full((64,), float(idx + 1))}).wait()
                committed = manager.should_commit()
            return {"regions": manager.replica_regions(),
                    "capable": manager.hier_capable(),
                    "avg": out["g"].clone(), "committed": committed}

        res = _two_groups(step, region=["east", "west"], host_label=["", ""])
        for r in res.values():
            assert sorted(r["regions"]) == ["east", "west"]
            assert r["capable"] and r["committed"]
            assert torch.equal(r["avg"], torch.full((64,), 1.5))

    def test_host_label_flows_to_shm_tier(self, monkeypatch):
        monkeypatch.setenv("TORCHFT_HOST", "testhost0")

        def step(manager, hc, idx):
            for _ in range(2):  # as above: the first step is an init sync
                manager.start_quorum()
                out = manager.plan_allreduce(
                    {"g": torch.full((64,), float(idx + 1))}, hier=True).wait()
                committed = manager.should_commit()
            return {"hosts": manager.replica_hosts(),
                    "capable": manager.hier_capable(),
                    "transport": hc.host_tier_transport(),
                    "avg": out["g"].clone(), "committed": committed}

        res = _two_groups(step)
        for r in res.values():
            assert r["hosts"] == ["testhost0"] * 2
            assert r["capable"] and r["transport"] == "shm" and r["committed"]
            assert torch.equal(r["avg"], torch.full((64,), 1.5))

    def test_unlabeled_cohort_latches_hier(self):
        healed = threading.Barrier(2)

        def step(manager, hc, idx):
            manager.start_quorum()
            # group 1's initial weight sync is fetched before either group
            # fails its step and votes (the donor's vote closes its
            # checkpoint gate; a step that fails at once would race it)
            manager.wait_quorum()
            healed.wait(timeout=30)
            capable = manager.hier_capable()
            out = manager.plan_allreduce({"g": torch.ones(8)}, hier=True).wait()
            discarded = not manager.should_commit()
            # the next flat step commits again
            manager.start_quorum()
            flat = manager.plan_allreduce({"g": torch.ones(8)}).wait()
            return {"capable": capable, "out": out, "errored": discarded,
                    "flat": flat["g"].clone(), "committed": manager.should_commit()}

        res = _two_groups(step, region=["", ""], host_label=["", ""])
        for r in res.values():
            assert not r["capable"]
            assert r["out"] is None and r["errored"]
            assert r["committed"]
        assert torch.equal(res[0]["flat"], res[1]["flat"])


# ---- the slice: PipelinedDDP(hier=True) against the JAX package ----

_KW = dict(vocab_size=128, d_model=32, n_heads=4, n_layers=2, d_ff=64,
           max_seq_len=64)


def _tokens(group, step):
    rng = np.random.default_rng(1000 * group + step)
    return rng.integers(0, _KW["vocab_size"], size=(2, 17), dtype=np.int32)


def _fleet(lighthouse_cls, run, init):
    lighthouse = lighthouse_cls(min_replicas=2, join_timeout_ms=200,
                                quorum_tick_ms=50, heartbeat_timeout_ms=4000)
    try:
        with ThreadPoolExecutor(max_workers=2) as ex:
            futures = [ex.submit(run, g, lighthouse.address(), init)
                       for g in range(2)]
            return [f.result(timeout=180) for f in futures]
    finally:
        lighthouse.shutdown()


def _jax_group(g, lighthouse, init):
    import jax
    import jax.numpy as jnp
    import optax

    import torchft_tpu as jft
    from torchft_tpu.models import transformer as jt

    cfg = jt.TransformerConfig(**_KW, dtype=jnp.float32)
    vg = jax.jit(jax.value_and_grad(lambda p, t: jt.loss_fn(cfg, p, t)))
    state = jft.FTTrainState(jax.tree_util.tree_map(jnp.asarray, init),
                             optax.adamw(1e-3, weight_decay=1e-4))
    hc = jft.HostCollectives(timeout=_T, stripes=2)
    manager = jft.Manager(
        collectives=hc, load_state_dict=state.load_state_dict,
        state_dict=state.state_dict, min_replica_size=2, timeout=_T,
        quorum_timeout=_T, connect_timeout=_T, rank=0, world_size=1,
        lighthouse_addr=lighthouse, replica_id=f"g{g}", host_label="h0",
    )
    try:
        ddp = jft.PipelinedDDP(manager, state, vg, compress="q8",
                               transport="plan", hier=True)
        losses = [float(ddp.step(jnp.asarray(_tokens(g, i)))) for i in range(3)]
        assert ddp.flush()
        return {"losses": losses, "step": manager.current_step(),
                "capable": manager.hier_capable(),
                "params": [np.asarray(p) for p in
                           jax.tree_util.tree_leaves(state.params)]}
    finally:
        manager.shutdown()
        hc.shutdown()


def _port_group(g, lighthouse, init):
    import torchft_tpu_torch as tft
    from torchft_tpu_torch._tree import flatten
    from torchft_tpu_torch.models import transformer as tt

    cfg = tt.TransformerConfig(**_KW, dtype=torch.float32)
    model = tt.TransformerLM(cfg, device="cpu")
    model.load_params(tt.params_from_jax(init, device="cpu"))
    state = tft.FTTrainState(model.params(), tft.AdamW(1e-3, weight_decay=1e-4))
    hc = tft.HostCollectives(timeout=_T, stripes=2)
    manager = tft.Manager(
        collectives=hc, load_state_dict=state.load_state_dict,
        state_dict=state.state_dict, min_replica_size=2, timeout=_T,
        quorum_timeout=_T, connect_timeout=_T, rank=0, world_size=1,
        lighthouse_addr=lighthouse, replica_id=f"g{g}", host_label="h0",
        device="cpu",
    )
    try:
        ddp = tft.PipelinedDDP(manager, state, tt.make_grad_fn(cfg),
                               compress="q8", transport="plan", hier=True)
        losses = [float(ddp.step(torch.from_numpy(_tokens(g, i)).long()))
                  for i in range(3)]
        assert ddp.flush()
        stats = manager.observe_op_stats()
        return {"losses": losses, "step": manager.current_step(),
                "capable": manager.hier_capable(),
                "hier_ops": sum(1 for st in stats if st.get("hier")),
                "params": [p.detach().numpy().copy()
                           for p in flatten(state.params)[0]]}
    finally:
        manager.shutdown()
        hc.shutdown()


def test_hier_pipelined_ddp_tracks_jax_groups():
    """Two co-hosted groups of each package: one region, so the sync is
    the f32 average over the shm host tier (no inter hop, no q8). Losses
    to rel 1e-4 and parameters to 1e-5 of each leaf's absmax, as in
    tests/test_torch_slice.py (f32 summation order differs between XLA
    and torch); each package's groups end bit-identical."""
    import jax

    import torchft_tpu as jft
    import torchft_tpu_torch as tft
    from torchft_tpu.models import transformer as jt

    init = jax.tree_util.tree_map(np.asarray, jt.init_params(
        jt.TransformerConfig(**_KW, dtype=jax.numpy.float32),
        jax.random.PRNGKey(0)))
    jres = _fleet(jft.Lighthouse, _jax_group, init)
    tres = _fleet(tft.Lighthouse, _port_group, init)
    for j, t in zip(jres, tres):
        assert j["step"] == t["step"] == 3
        assert j["capable"] and t["capable"]
        assert t["hier_ops"] >= 3
        np.testing.assert_allclose(t["losses"], j["losses"], rtol=1e-4)
    for res in (jres, tres):
        for a, b in zip(res[0]["params"], res[1]["params"]):
            assert a.tobytes() == b.tobytes()
    for tl, jl in zip(tres[0]["params"], jres[0]["params"]):
        np.testing.assert_allclose(tl, jl, rtol=0,
                                   atol=1e-5 * np.max(np.abs(jl)))
