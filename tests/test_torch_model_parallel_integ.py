"""Intra-group model parallelism composed with the port's fault tolerance,
end to end: the port's counterparts of ``tests/test_hsdp_integ.py`` (data
x tensor), ``tests/test_pp_integ.py`` (data x pipe) and
``tests/test_ep_integ.py`` (data x expert).

Each replica group is a mesh of four ranks, each rank a thread with its
own ``Manager(rank=r, world_size=4)`` (rank 0 hosts the group's manager
server), its own ``HostCollectives`` and its block of the model; the
group's ranks run ``build_grad_step`` over the mesh (gloo groups), and
each rank's gradient block crosses to the other group's same rank over
its own ring (``/{rank}`` store prefixes), the reference's HSDP layout.
Two groups train 4 steps and end bit-identical rank for rank. Then
group 1 dies after step 2 (every rank's Manager shut down) and restarts
from other weights; each of its ranks heals its block from group 0's
same rank and the groups again end bit-identical.
"""

import dataclasses
import functools
import threading
from datetime import timedelta

import numpy as np
import pytest
import torch

import torch_one_thread  # noqa: F401

import torch.distributed as dist

import torchft_tpu_torch as tft
from torchft_tpu_torch import parallel as par
from torchft_tpu_torch import pipeline as tpp
from torchft_tpu_torch._native import Store
from torchft_tpu_torch._tree import flatten, tree_map
from torchft_tpu_torch.models import moe as tmoe
from torchft_tpu_torch.models import transformer as tt

_T = timedelta(seconds=60)
KW = dict(vocab_size=256, d_model=64, n_heads=4, n_layers=2, d_ff=128,
          max_seq_len=128, dtype=torch.float32)


def _family(name):
    """(mesh axes, whole params from a seed, rules, loss_fn(mesh))."""
    if name == "hsdp":
        cfg = tt.TransformerConfig(**KW)
        return ({"data": 2, "model": 2},
                lambda seed: tt.init_params(cfg, seed, "cpu"),
                tt.param_sharding_rules(cfg),
                lambda mesh: functools.partial(
                    tt.loss_fn, dataclasses.replace(cfg, cp_mesh=mesh)))
    if name == "ep":
        cfg = tmoe.MoEConfig(**KW, n_experts=4)
        axes = {"data": 2, "expert": 2}
        rules = par.restrict_rules(tmoe.param_sharding_rules(cfg),
                                   par.Mesh(axes, 0, {}, "gloo"))
        return (axes, lambda seed: tmoe.init_params(cfg, seed, "cpu"), rules,
                lambda mesh: functools.partial(
                    tmoe.loss_fn, dataclasses.replace(cfg, cp_mesh=mesh)))
    cfg = tt.TransformerConfig(**KW)  # "pp": one layer a stage

    def whole(seed):
        raw = tt.init_params(cfg, seed, "cpu")
        return {"backbone": {k: v for k, v in raw.items() if k != "blocks"},
                "stacked": tpp.stack_blocks(raw["blocks"])}

    shapes = whole(0)
    rules = {"backbone": tree_map(lambda l: (), shapes["backbone"]),
             "stacked": tpp.stage_specs(shapes["stacked"])}

    def loss(mesh):
        def fn(params, tokens):
            x = tt.embed_tokens(cfg, params["backbone"], tokens[:, :-1])
            x = tpp.pipeline_blocks(functools.partial(tt._block, cfg),
                                    params["stacked"], x, mesh=mesh,
                                    microbatches=2, data_axis="data")
            return tt.next_token_loss(tt.readout(cfg, params["backbone"], x),
                                      tokens[:, 1:])
        return fn

    return {"data": 2, "pipe": 2}, whole, rules, loss


def _batch(step):
    return torch.tensor(np.random.default_rng(9000 + step).integers(
        0, KW["vocab_size"], (4, 33)))


class _Group:
    """One incarnation of a replica group: a rank thread per mesh position."""

    def __init__(self, family, g, lighthouse, seed, num_steps, stop_after=None,
                 gate=None):
        self.axes, self.whole, self.rules, self.loss = _family(family)
        self.family, self.g, self.lighthouse = family, g, lighthouse
        self.seed, self.num_steps = seed, num_steps
        self.stop_after, self.gate = stop_after, gate
        self.world = int(np.prod(list(self.axes.values())))
        self.store = Store()
        self.mesh_store = dist.HashStore()
        self.results = [None] * self.world
        self.errors = []
        self.up = threading.Event()
        self._ready = [False] * self.world
        self.threads = [threading.Thread(target=self._rank, args=(r,),
                                         daemon=True)
                        for r in range(self.world)]

    def start(self):
        for t in self.threads:
            t.start()
        return self

    def join(self, timeout=240):
        for t in self.threads:
            t.join(timeout)
        assert not any(t.is_alive() for t in self.threads), "a rank hung"
        self.store.shutdown()
        if self.errors:
            raise self.errors[0]
        return self.results

    def _rank(self, rank):
        mesh = manager = collectives = None
        try:
            mesh = par.make_mesh(self.axes, rank=rank, world_size=self.world,
                                 store=self.mesh_store, timeout=_T)
            state = tft.FTTrainState(
                par.shard_pytree(self.whole(self.seed), self.rules, mesh),
                tft.SGD(0.05))
            step_fn = par.build_grad_step(self.loss(mesh), mesh, self.rules)
            collectives = tft.HostCollectives(timeout=_T)
            manager = tft.Manager(
                collectives=collectives, load_state_dict=state.load_state_dict,
                state_dict=state.state_dict, min_replica_size=1, timeout=_T,
                quorum_timeout=_T, connect_timeout=_T, rank=rank,
                world_size=self.world, store_addr=self.store.address(),
                lighthouse_addr=self.lighthouse.address(),
                replica_id=f"{self.family}_{self.g}", device="cpu")
            self._ready[rank] = True
            if all(self._ready):
                self.up.set()
            optimizer = tft.OptimizerWrapper(manager, state)
            commits = []
            while manager.current_step() < self.num_steps:
                if self.stop_after is not None and \
                        manager.current_step() >= self.stop_after:
                    break  # this incarnation dies between steps
                if self.gate is not None and \
                        manager.current_step() == self.gate[0]:
                    assert self.gate[1].wait(120)
                optimizer.zero_grad()
                _, grads = step_fn(state.params, _batch(manager.current_step()))
                avg = manager.allreduce(grads).wait()
                commits.append(optimizer.step(avg))
            self.results[rank] = {
                "params": [l.clone() for l in flatten(state.params)[0]],
                "step": manager.current_step(),
                "commits": commits,
                "heals": manager.metrics().snapshot()["counters"].get("heals", 0),
                "fetch": manager.checkpoint_transport().last_fetch_stats,
            }
        except BaseException as e:  # noqa: BLE001 - re-raised by join
            self.errors.append(e)
        finally:
            if manager is not None:
                manager.shutdown()
            if collectives is not None:
                collectives.shutdown()
            if mesh is not None:
                mesh.shutdown()


def _lighthouse():
    return tft.Lighthouse(bind="[::]:0", min_replicas=1, join_timeout_ms=200,
                          quorum_tick_ms=50, heartbeat_timeout_ms=1500)


def _assert_bit_identical(a, b):
    for ra, rb in zip(a, b):
        for x, y in zip(ra["params"], rb["params"]):
            assert torch.equal(x, y)


@pytest.mark.parametrize("family", ["hsdp", "pp", "ep"])
def test_groups_of_four_ranks_stay_bit_identical(family):
    lighthouse = _lighthouse()
    try:
        groups = [_Group(family, g, lighthouse, seed=42, num_steps=4).start()
                  for g in range(2)]
        results = [grp.join() for grp in groups]
    finally:
        lighthouse.shutdown()
    for res in results:
        assert [r["step"] for r in res] == [4] * 4
    _assert_bit_identical(*results)
    # a rank's block differs from its peers' (the model really is split)
    assert not all(torch.equal(x, y) for x, y in
                   zip(results[0][0]["params"], results[0][1]["params"])
                   if x.shape == y.shape)


@pytest.mark.parametrize("family", ["hsdp", "pp", "ep"])
def test_group_killed_and_healed_per_rank(family):
    lighthouse = _lighthouse()
    restarted = threading.Event()
    try:
        survivor = _Group(family, 0, lighthouse, seed=42, num_steps=6,
                          gate=(3, restarted)).start()
        victim = _Group(family, 1, lighthouse, seed=42, num_steps=6,
                        stop_after=2).start()
        first = victim.join()
        assert [r["step"] for r in first] == [2] * 4
        # the restart holds other weights: only the heal can make it equal
        healed = _Group(family, 1, lighthouse, seed=7, num_steps=6).start()
        assert healed.up.wait(120)
        restarted.set()
        second = healed.join()
        ref = survivor.join()
    finally:
        lighthouse.shutdown()
    for r in second:
        assert r["heals"] == 1 and r["step"] == 6
        assert r["fetch"]["path"] == "stream"
    _assert_bit_identical(ref, second)
