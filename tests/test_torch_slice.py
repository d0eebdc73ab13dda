"""The slice end to end on the CPU: quorum, forward/backward, the q8ef
PipelinedDDP sync over the comm plan, commit vote, heal.

- Two port replica groups against two JAX replica groups on the same
  data and the same weights (carried with ``params_from_jax``), f32
  compute, dense attention and again with ``use_flash=True`` (the port's
  plain flash path against the JAX Pallas kernels in interpret mode),
  three ``PipelinedDDP(compress="q8", transport="plan")`` steps:
  per-step losses agree to rel 1e-4 (f32 summation order differs between
  XLA and torch), and the first step's averaged gradients to 1e-5 of each
  leaf's absmax.
- A port-only kill-and-heal run whose oracle is bit-identical parameters
  across the groups after recovery (the tests/test_manager_integ.py
  oracle).
- ROADMAP F1 through the DDP: a 0x7FFFFFFF gradient element rides
  ``PipelinedDDP(compress="bf16")`` and every member applies a NaN.

Replica groups are threads with their own Manager; ports bind to 0.
"""

from concurrent.futures import ThreadPoolExecutor
from datetime import timedelta

import numpy as np
import pytest
import torch

import torch_one_thread  # noqa: F401

import jax
import jax.numpy as jnp
import optax

import torchft_tpu as jft
from torchft_tpu.models import transformer as jt
import torchft_tpu_torch as tft
from torchft_tpu_torch._tree import flatten
from torchft_tpu_torch.models import transformer as tt

_KW = dict(vocab_size=128, d_model=32, n_heads=4, n_layers=2, d_ff=64,
           max_seq_len=64)
_TIMEOUT = timedelta(seconds=30)


def _tokens(group, step):
    rng = np.random.default_rng(1000 * group + step)
    return rng.integers(0, _KW["vocab_size"], size=(2, 17), dtype=np.int32)


def _jax_init():
    cfg = jt.TransformerConfig(**_KW, dtype=jnp.float32)
    return jax.tree_util.tree_map(
        np.asarray, jt.init_params(cfg, jax.random.PRNGKey(0))
    )


class _Recorder:
    """Wraps a state's apply_gradients to keep the averaged gradients
    each committed step applied (as numpy, in tree_util leaf order)."""

    def __init__(self, state, leaves_fn):
        self.applied = []
        inner = state.apply_gradients

        def apply(grads):
            self.applied.append([np.array(l) for l in leaves_fn(grads)])
            inner(grads)

        state.apply_gradients = apply


def _run_jax_group(g, lighthouse, init, steps, extra=None):
    cfg = jt.TransformerConfig(**_KW, **(extra or {}), dtype=jnp.float32)
    vg = jax.jit(jax.value_and_grad(lambda p, t: jt.loss_fn(cfg, p, t)))
    state = jft.FTTrainState(
        jax.tree_util.tree_map(jnp.asarray, init),
        optax.adamw(1e-3, weight_decay=1e-4),
    )
    rec = _Recorder(state, jax.tree_util.tree_leaves)
    collectives = jft.HostCollectives(timeout=_TIMEOUT, stripes=2)
    manager = jft.Manager(
        collectives=collectives, load_state_dict=state.load_state_dict,
        state_dict=state.state_dict, min_replica_size=2, timeout=_TIMEOUT,
        quorum_timeout=_TIMEOUT, connect_timeout=_TIMEOUT, rank=0,
        world_size=1, lighthouse_addr=lighthouse, replica_id=f"g{g}",
    )
    try:
        ddp = jft.PipelinedDDP(manager, state, lambda p, t: vg(p, t),
                               compress="q8", transport="plan")
        losses = [float(ddp.step(jnp.asarray(_tokens(g, i))))
                  for i in range(steps)]
        assert ddp.flush()
        return {"losses": losses, "applied": rec.applied,
                "step": manager.current_step()}
    finally:
        manager.shutdown()
        collectives.shutdown()


def _port_group(g, lighthouse, init, min_replicas=2, device_pack=True,
                compress="q8", grad_hook=None, extra=None):
    cfg = tt.TransformerConfig(**_KW, **(extra or {}), dtype=torch.float32)
    model = tt.TransformerLM(cfg, device="cpu")
    model.load_params(tt.params_from_jax(init, device="cpu"))
    state = tft.FTTrainState(model.params(),
                             tft.AdamW(1e-3, weight_decay=1e-4))
    rec = _Recorder(state, lambda t: flatten(t)[0])
    collectives = tft.HostCollectives(timeout=_TIMEOUT, stripes=2)
    manager = tft.Manager(
        collectives=collectives, load_state_dict=state.load_state_dict,
        state_dict=state.state_dict, min_replica_size=min_replicas,
        timeout=_TIMEOUT, quorum_timeout=_TIMEOUT, connect_timeout=_TIMEOUT,
        rank=0, world_size=1, lighthouse_addr=lighthouse, replica_id=f"g{g}",
        device="cpu",
    )
    grad_fn = tt.make_grad_fn(cfg)
    if grad_hook is not None:
        base = grad_fn

        def grad_fn(params, tokens):
            loss, grads = base(params, tokens)
            return loss, grad_hook(grads)

    ddp = tft.PipelinedDDP(manager, state, grad_fn, compress=compress,
                           transport="plan", device_pack=device_pack)
    return model, state, rec, collectives, manager, ddp


def _run_port_group(g, lighthouse, init, steps, extra=None):
    model, state, rec, collectives, manager, ddp = _port_group(
        g, lighthouse, init, extra=extra)
    try:
        losses = [float(ddp.step(torch.from_numpy(_tokens(g, i)).long()))
                  for i in range(steps)]
        assert ddp.flush()
        return {"losses": losses, "applied": rec.applied,
                "step": manager.current_step()}
    finally:
        manager.shutdown()
        collectives.shutdown()


def _fleet(lighthouse_cls, run, *args, n=2):
    lighthouse = lighthouse_cls(min_replicas=n, join_timeout_ms=200,
                                quorum_tick_ms=50, heartbeat_timeout_ms=4000)
    try:
        with ThreadPoolExecutor(max_workers=n) as ex:
            futures = [ex.submit(run, g, lighthouse.address(), *args)
                       for g in range(n)]
            return [f.result(timeout=180) for f in futures]
    finally:
        lighthouse.shutdown()


def _groups_track_jax_groups(extra=None):
    init = _jax_init()
    steps = 3
    jres = _fleet(jft.Lighthouse, _run_jax_group, init, steps, extra)
    tres = _fleet(tft.Lighthouse, _run_port_group, init, steps, extra)
    for j, t in zip(jres, tres):
        assert j["step"] == t["step"] == steps
        np.testing.assert_allclose(t["losses"], j["losses"], rtol=1e-4)
        assert len(t["applied"]) == len(j["applied"]) == steps
    # the groups of each package applied one averaged tree per step
    for res in (jres, tres):
        for a, b in zip(res[0]["applied"][0], res[1]["applied"][0]):
            assert a.tobytes() == b.tobytes()
    for tl, jl in zip(tres[0]["applied"][0], jres[0]["applied"][0]):
        assert tl.shape == jl.shape
        np.testing.assert_allclose(tl, jl, rtol=0,
                                   atol=1e-5 * np.max(np.abs(jl)))


def test_port_groups_track_jax_groups():
    _groups_track_jax_groups()


def test_port_groups_track_jax_groups_use_flash():
    _groups_track_jax_groups({"use_flash": True})


class _InjectedFailure(Exception):
    pass


def _run_port_replica(g, lighthouse, init, steps, fail_at, restarts):
    """Runs a group to ``steps`` committed steps; a group with ``fail_at``
    raises there once (taking its manager and ring down) and re-enters
    with fresh state, which then heals from the live peer."""
    for attempt in range(3):
        model, state, rec, collectives, manager, ddp = _port_group(
            g, lighthouse, init, min_replicas=1
        )
        try:
            i = 0
            while manager.current_step() < steps:
                if attempt == 0 and fail_at is not None and \
                        manager.current_step() == fail_at[g]:
                    raise _InjectedFailure(f"group {g} at {fail_at[g]}")
                ddp.step(torch.from_numpy(_tokens(g, i)).long())
                i += 1
            ddp.flush()
            return {
                "params": [p.detach().numpy().copy()
                           for p in flatten(state.params)[0]],
                "step": manager.current_step(),
                "heals": manager.metrics().snapshot()["counters"].get("heals", 0),
            }
        except _InjectedFailure:
            restarts.append(g)
            continue
        finally:
            manager.shutdown()
            collectives.shutdown()
    raise RuntimeError(f"group {g} exhausted its restarts")


def test_kill_and_heal_bit_identical():
    init = _jax_init()
    restarts = []
    res = _fleet(
        tft.Lighthouse, _run_port_replica, init, 6, {0: None, 1: 2}, restarts,
    )
    assert restarts == [1]
    assert res[0]["step"] == res[1]["step"] >= 6
    assert res[1]["heals"] >= 1
    for a, b in zip(res[0]["params"], res[1]["params"]):
        assert a.tobytes() == b.tobytes(), "healed group diverged"


@pytest.mark.parametrize("device_pack", [False, True])
def test_bf16_ddp_carries_high_mantissa_nan(device_pack):
    init = _jax_init()

    def poison(grads):
        leaves, _ = flatten(grads)
        leaves[0].view(torch.int32).view(-1)[3] = 0x7FFFFFFF
        return grads

    def run(g, lighthouse):
        model, state, rec, collectives, manager, ddp = _port_group(
            g, lighthouse, init, device_pack=device_pack, compress="bf16",
            grad_hook=poison if g == 0 else None,
        )
        try:
            ddp.step(torch.from_numpy(_tokens(g, 0)).long())
            ddp.flush()
            return rec.applied
        finally:
            manager.shutdown()
            collectives.shutdown()

    for applied in _fleet(tft.Lighthouse, run):
        assert len(applied) == 1
        first = applied[0][0].reshape(-1)
        assert np.isnan(first[3])
        assert np.isfinite(np.delete(first, 3)).all()


def test_optimizer_wrapper_loop_commits_bit_identical():
    """The canonical blocking loop: ``OptimizerWrapper.zero_grad`` starts
    the quorum, ``DistributedDataParallel`` averages through the managed
    allreduce, ``OptimizerWrapper.step`` applies iff the vote commits."""
    init = _jax_init()

    def run(g, lighthouse):
        model, state, rec, collectives, manager, _ = _port_group(g, lighthouse, init)
        optimizer = tft.OptimizerWrapper(manager, state)
        ddp = tft.DistributedDataParallel(manager)
        grad_fn = tt.make_grad_fn(model.cfg)
        try:
            committed = []
            for i in range(3):
                optimizer.zero_grad()
                _, grads = grad_fn(state.params, torch.from_numpy(_tokens(g, i)).long())
                committed.append(optimizer.step(ddp.allreduce_grads(grads).wait()))
            return committed, [p.detach().numpy().copy()
                               for p in flatten(state.params)[0]]
        finally:
            manager.shutdown()
            collectives.shutdown()

    (c0, p0), (c1, p1) = _fleet(tft.Lighthouse, run)
    assert c0 == c1 == [True, True, True]
    for a, b in zip(p0, p1):
        assert a.tobytes() == b.tobytes()


def test_wrap_grad_fn_matches_the_jax_package():
    """``DistributedDataParallel.wrap_grad_fn`` of both packages on the
    same numpy inputs, each over a mocked Manager whose allreduce averages
    the grads with a fixed peer's (tests/test_api.py's pattern): the same
    value and the same averaged grads, one allreduce a call."""
    from unittest.mock import create_autospec

    from torchft_tpu.collectives import _completed as jax_completed
    from torchft_tpu_torch.collectives import _completed as port_completed

    rng = np.random.default_rng(15)
    w, x, y, peer = (rng.standard_normal(s).astype(np.float32)
                     for s in ((4, 3), (5, 4), (5, 3), (4, 3)))

    jax_manager = create_autospec(jft.Manager, instance=True)
    jax_manager.allreduce.side_effect = lambda g: jax_completed(
        {"w": (g["w"] + peer) / 2})
    port_manager = create_autospec(tft.Manager, instance=True)
    port_manager.allreduce.side_effect = lambda g: port_completed(
        {"w": (g["w"] + torch.from_numpy(peer)) / 2})

    def jax_loss(p, x, y):
        return jnp.mean((x @ p["w"] - y) ** 2)

    def port_grad_fn(p, x, y):
        pw = p["w"].clone().requires_grad_(True)
        loss = ((x @ pw - y) ** 2).mean()
        (g,) = torch.autograd.grad(loss, [pw])
        return loss.detach(), {"w": g}

    jax_fn = jft.DistributedDataParallel(jax_manager).wrap_grad_fn(
        jax.value_and_grad(jax_loss))
    port_fn = tft.DistributedDataParallel(port_manager).wrap_grad_fn(
        port_grad_fn)
    jv, jg = jax_fn({"w": jnp.asarray(w)}, jnp.asarray(x), jnp.asarray(y))
    pv, pg = port_fn({"w": torch.from_numpy(w)}, torch.from_numpy(x),
                     torch.from_numpy(y))
    np.testing.assert_allclose(float(pv), float(jv), rtol=1e-6)
    np.testing.assert_allclose(pg["w"].numpy(), np.asarray(jg["w"]),
                               rtol=1e-5, atol=1e-6)
    want = (2 * x.T @ (x @ w - y) / y.size + peer) / 2
    np.testing.assert_allclose(pg["w"].numpy(), want, rtol=1e-5, atol=1e-6)
    jax_manager.allreduce.assert_called_once()
    port_manager.allreduce.assert_called_once()
