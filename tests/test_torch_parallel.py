"""The port's mesh (``torchft_tpu_torch.parallel``) against the JAX
package's ``parallel`` on the same inputs.

Mesh ranks run as threads of this process over explicit gloo groups
(``run_thread_mesh``); the JAX side runs on the 8 virtual CPU devices of
``tests/conftest.py``. Seeded numpy inputs go through both.

- ``make_mesh``: the JAX size check and message; a rank sits where
  ``jax.sharding.Mesh`` puts device ``rank``.
- ``shard_pytree``: every rank's block of every leaf equals the JAX
  array's ``addressable_shards`` entry on that device, for the
  transformer, MoE and CNN rule trees, which equal the JAX package's
  (``PartitionSpec`` s as tuples).
- The five collectives against the same ``lax`` collective under
  ``shard_map``, forward and gradient (their backward is the adjoint).
- ``build_grad_step`` on ``{"data": 2, "model": 2}``: loss and gradients
  against the JAX package's jitted step in f32 (rtol 1e-5 / atol 1e-6),
  the loss in the bf16 default within 3e-3; tensor-parallel gradients
  against the unsharded port.
"""

import dataclasses

import numpy as np
import pytest
import torch

import torch_one_thread  # noqa: F401

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from conftest import HAS_SHARD_MAP, SHARD_MAP_SKIP

from torchft_tpu import parallel as jpar
from torchft_tpu.models import cnn as jcnn
from torchft_tpu.models import moe as jmoe
from torchft_tpu.models import transformer as jt
from torchft_tpu_torch import parallel as par
from torchft_tpu_torch._tree import flatten, unflatten
from torchft_tpu_torch.models import cnn as tcnn
from torchft_tpu_torch.models import moe as tmoe
from torchft_tpu_torch.models import transformer as tt

RTOL, ATOL = 1e-5, 1e-6
BF16_TOL = 3e-3
TINY = dict(vocab_size=256, d_model=64, n_heads=4, n_layers=2, d_ff=128,
            max_seq_len=128)


def _spec_tree(rules):
    """A JAX rule tree with each PartitionSpec as a tuple."""
    return jax.tree_util.tree_map(
        lambda s: tuple(s), rules, is_leaf=lambda x: isinstance(x, P))


def _jax_mesh(axes):
    return jpar.make_mesh(axes, devices=jax.devices()[:int(np.prod(list(axes.values())))])


def _rank_of(jmesh, device):
    return int(np.flatnonzero(jmesh.devices.reshape(-1) == device)[0])


# -- the mesh -------------------------------------------------------------------


def test_mesh_size_check_and_message():
    with pytest.raises(ValueError) as port:
        par.make_mesh({"data": 2, "model": 2}, rank=0, world_size=3, store=None)
    with pytest.raises(ValueError) as ref:
        jpar.make_mesh({"data": 2, "model": 2}, devices=jax.devices()[:3])
    assert str(port.value) == str(ref.value)


@pytest.mark.parametrize("kwargs,match", [
    (dict(rank=4, world_size=4), "outside"),
    (dict(rank=0, world_size=4, backend="mpi"), "backend"),
])
def test_mesh_rejects_bad_rank_and_backend(kwargs, match):
    with pytest.raises(ValueError, match=match):
        par.make_mesh({"data": 2, "model": 2}, store=None, **kwargs)


def test_mesh_coords_follow_the_jax_device_layout():
    axes = {"data": 2, "seq": 2, "model": 2}
    jmesh = _jax_mesh(axes)
    for rank in range(8):
        mesh = par.Mesh(axes, rank, {}, "gloo")
        pos = np.argwhere(jmesh.devices == jax.devices()[rank])[0]
        assert mesh.coords == dict(zip(axes, (int(p) for p in pos)))
    # one group per axis of size > 1, each of the axis' size
    sizes = par.run_thread_mesh(
        {"data": 2, "model": 2},
        lambda m: {a: g.size() for a, g in m.groups.items()})
    assert sizes == [{"data": 2, "model": 2}] * 4


# -- rules and blocks --------------------------------------------------------------


def _rule_pairs():
    return {
        "transformer": (jt.param_sharding_rules(jt.tiny_config()),
                        tt.param_sharding_rules(tt.tiny_config())),
        "moe": (jmoe.param_sharding_rules(jmoe.tiny_moe_config()),
                tmoe.param_sharding_rules(tmoe.tiny_moe_config())),
        "cnn": (jcnn.param_sharding_rules(jcnn.tiny_cnn_config()),
                tcnn.param_sharding_rules(tcnn.tiny_cnn_config())),
    }


@pytest.mark.parametrize("family", ["transformer", "moe", "cnn"])
def test_rule_trees_equal_the_jax_package(family):
    jrules, trules = _rule_pairs()[family]
    assert _spec_tree(jrules) == trules


def _family_params(family):
    if family == "transformer":
        cfg = jt.tiny_config()
        return jt.init_params(cfg, jax.random.PRNGKey(3)), jt.param_sharding_rules(cfg)
    if family == "moe":
        cfg = jmoe.tiny_moe_config()
        return jmoe.init_params(cfg, jax.random.PRNGKey(3)), jmoe.param_sharding_rules(cfg)
    cfg = jcnn.tiny_cnn_config()
    return jcnn.init_params(cfg, jax.random.PRNGKey(3)), jcnn.param_sharding_rules(cfg)


@pytest.mark.skipif(not HAS_SHARD_MAP, reason=SHARD_MAP_SKIP)
@pytest.mark.parametrize("family,axes", [
    ("transformer", {"data": 2, "model": 2}),
    ("transformer", {"model": 4}),
    ("moe", {"data": 2, "expert": 2, "model": 2}),
    ("cnn", {"data": 4}),
])
def test_shard_pytree_blocks_equal_addressable_shards(family, axes):
    jparams, jrules = _family_params(family)
    jmesh = _jax_mesh(axes)
    placed = jpar.shard_pytree(jparams, jrules, jmesh)
    whole = jax.tree_util.tree_map(
        lambda l: torch.tensor(np.asarray(l)), jparams)
    trules = _spec_tree(jrules)
    jleaves = jax.tree_util.tree_leaves(placed)
    for rank in range(len(jmesh.devices.flat)):
        mesh = par.Mesh(axes, rank, {}, "gloo")
        blocks, _ = flatten(par.shard_pytree(whole, trules, mesh))
        assert len(blocks) == len(jleaves)
        for block, leaf in zip(blocks, jleaves):
            shard = next(s for s in leaf.addressable_shards
                         if _rank_of(jmesh, s.device) == rank)
            np.testing.assert_array_equal(block.numpy(), np.asarray(shard.data))


def test_shard_pytree_rejects_uneven_and_unknown_axes():
    mesh = par.Mesh({"pipe": 2}, 0, {}, "gloo")
    with pytest.raises(ValueError, match="divisible"):
        par.shard_pytree({"w": torch.zeros(3, 4)}, {"w": ("pipe",)}, mesh)
    with pytest.raises(ValueError, match="not in the mesh"):
        par.shard_pytree({"w": torch.zeros(4, 4)}, {"w": (None, "model")}, mesh)
    # restrict_rules replicates what the mesh lacks
    assert par.restrict_rules({"w": (None, "model"), "v": ("pipe", None)},
                              mesh) == {"w": (None, None), "v": ("pipe", None)}


# -- the collectives ------------------------------------------------------------


def _local_inputs(n, shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _jax_collective(name, xs, ws):
    """The lax collective over a 4-device axis under shard_map, and the
    gradient of sum(out * w) per rank."""
    from jax import shard_map

    n = len(xs)
    mesh = _jax_mesh({"x": n})
    ops = {
        "all_reduce": lambda x: jax.lax.psum(x, "x"),
        "all_gather": lambda x: jax.lax.all_gather(x, "x", axis=1, tiled=True),
        "reduce_scatter": lambda x: jax.lax.psum_scatter(
            x, "x", scatter_dimension=1, tiled=True),
        "all_to_all": lambda x: jax.lax.all_to_all(
            x, "x", split_axis=1, concat_axis=0, tiled=True),
        "ppermute": lambda x: jax.lax.ppermute(
            x, "x", [(i, (i + 1) % n) for i in range(n - 1)]),
    }
    op = ops[name]
    X = jnp.concatenate([x[None] for x in xs])
    f = shard_map(lambda x: op(x[0])[None], mesh=mesh, in_specs=P("x"),
                  out_specs=P("x"), check_vma=False)
    out = f(X)
    W = jnp.concatenate([w[None] for w in ws])
    grad = jax.grad(lambda X: jnp.sum(f(X) * W))(X)
    return np.asarray(out), np.asarray(grad)


def _port_collective(name, mesh, x):
    n = mesh.axis_size("x")
    if name == "all_reduce":
        return par.all_reduce(x, mesh, "x")
    if name == "all_gather":
        return par.all_gather(x, mesh, "x", dim=1)
    if name == "reduce_scatter":
        return par.reduce_scatter(x, mesh, "x", dim=1)
    if name == "all_to_all":
        return par.all_to_all(x, mesh, "x", 1, 0)
    return par.ppermute(x, mesh, "x", [(i, (i + 1) % n) for i in range(n - 1)])


@pytest.mark.skipif(not HAS_SHARD_MAP, reason=SHARD_MAP_SKIP)
@pytest.mark.parametrize("name", ["all_reduce", "all_gather", "reduce_scatter",
                                  "all_to_all", "ppermute"])
def test_collective_and_its_adjoint_match_lax(name):
    n, shape = 4, (4, 8)
    xs = _local_inputs(n, shape, 11)
    out_shape = {"all_gather": (4, 32), "reduce_scatter": (4, 2),
                 "all_to_all": (16, 2)}.get(name, shape)
    ws = _local_inputs(n, out_shape, 12)
    ref_out, ref_grad = _jax_collective(name, xs, ws)

    def fn(mesh):
        r = mesh.axis_index("x")
        x = torch.tensor(xs[r], requires_grad=True)
        out = _port_collective(name, mesh, x)
        (g,) = torch.autograd.grad((out * torch.tensor(ws[r])).sum(), x)
        return out.detach().numpy(), g.numpy()

    res = par.run_thread_mesh({"x": n}, fn)
    for r, (out, g) in enumerate(res):
        np.testing.assert_allclose(out, ref_out[r], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(g, ref_grad[r], rtol=RTOL, atol=ATOL)


def test_collectives_keep_bf16_and_move_bits():
    def fn(mesh):
        r = mesh.axis_index("x")
        x = torch.full((2, 3), 1.0 + r / 128, dtype=torch.bfloat16)
        return (par.all_reduce(x, mesh, "x"), par.all_gather(x, mesh, "x"),
                par.all_to_all(x, mesh, "x", 0, 1))

    res = par.run_thread_mesh({"x": 2}, fn)
    for red, gat, a2a in res:
        assert red.dtype == gat.dtype == a2a.dtype == torch.bfloat16
        assert torch.equal(red, torch.full((2, 3), 2 + 1 / 128,
                                           dtype=torch.bfloat16))
        assert torch.equal(gat[2:], torch.full((2, 3), 1 + 1 / 128,
                                               dtype=torch.bfloat16))


# -- the grad step -----------------------------------------------------------------


def _lm_setup(dtype_name, seed=0):
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype_name]
    jcfg = jt.TransformerConfig(**TINY, dtype=jdt)
    tcfg = tt.TransformerConfig(**TINY, dtype=tdt)
    jparams = jt.init_params(jcfg, jax.random.PRNGKey(seed))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    tokens = np.random.default_rng(seed).integers(
        0, TINY["vocab_size"], size=(4, 33), dtype=np.int32)
    return jcfg, tcfg, jparams, np_params, tokens


def _port_grad_step(tcfg, np_params, tokens, axes):
    rules = tt.param_sharding_rules(tcfg)
    whole = tt.params_from_jax(np_params, device="cpu")

    def fn(mesh):
        cfg = dataclasses.replace(tcfg, cp_mesh=mesh)
        step = par.build_grad_step(lambda p, b: tt.loss_fn(cfg, p, b), mesh,
                                   rules)
        loss, grads = step(par.shard_pytree(whole, rules, mesh),
                           torch.tensor(tokens))
        return float(loss), [g.numpy() for g in flatten(grads)[0]]

    return par.run_thread_mesh(axes, fn), rules


@pytest.mark.skipif(not HAS_SHARD_MAP, reason=SHARD_MAP_SKIP)
def test_build_grad_step_matches_jax_f32_data_x_model():
    axes = {"data": 2, "model": 2}
    jcfg, tcfg, jparams, np_params, tokens = _lm_setup("f32")
    jmesh = _jax_mesh(axes)
    jrules = jt.param_sharding_rules(jcfg)
    jstep = jpar.build_grad_step(lambda p, b: jt.loss_fn(jcfg, p, b), jmesh,
                                 jrules)
    jloss, jgrads = jstep(
        jpar.shard_pytree(jparams, jrules, jmesh),
        jax.device_put(jnp.asarray(tokens), NamedSharding(jmesh, P("data"))))
    jwhole = [torch.tensor(np.asarray(g))
              for g in jax.tree_util.tree_leaves(jgrads)]
    res, rules = _port_grad_step(tcfg, np_params, tokens, axes)
    _, treedef = flatten(tt.params_from_jax(np_params, device="cpu"))
    for rank, (loss, grads) in enumerate(res):
        np.testing.assert_allclose(loss, float(jloss), rtol=RTOL, atol=ATOL)
        ref = flatten(par.shard_pytree(unflatten(treedef, jwhole), rules,
                                       par.Mesh(axes, rank, {}, "gloo")))[0]
        for g, r in zip(grads, ref):
            np.testing.assert_allclose(g, r.numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.skipif(not HAS_SHARD_MAP, reason=SHARD_MAP_SKIP)
def test_build_grad_step_bf16_loss_within_tolerance():
    axes = {"data": 2, "model": 2}
    jcfg, tcfg, jparams, np_params, tokens = _lm_setup("bf16", seed=1)
    jloss = float(jt.loss_fn(jcfg, jparams, jnp.asarray(tokens)))
    res, _ = _port_grad_step(tcfg, np_params, tokens, axes)
    for loss, grads in res:
        np.testing.assert_allclose(loss, jloss, rtol=BF16_TOL)
        assert all(np.isfinite(g).all() for g in grads)


@pytest.mark.parametrize("axes", [{"model": 2}, {"model": 4},
                                  {"data": 2, "model": 2}])
def test_tensor_parallel_grads_match_unsharded(axes):
    _, tcfg, _, np_params, tokens = _lm_setup("f32", seed=2)
    whole = tt.params_from_jax(np_params, device="cpu")
    leaves, treedef = flatten(whole)
    work = [l.clone().requires_grad_(True) for l in leaves]
    loss = tt.loss_fn(tcfg, unflatten(treedef, work), torch.tensor(tokens))
    ref = torch.autograd.grad(loss, work)
    res, rules = _port_grad_step(tcfg, np_params, tokens, axes)
    for rank, (l, grads) in enumerate(res):
        np.testing.assert_allclose(l, float(loss.detach()), rtol=RTOL, atol=ATOL)
        blocks = flatten(par.shard_pytree(unflatten(treedef, list(ref)), rules,
                                          par.Mesh(axes, rank, {}, "gloo")))[0]
        for g, r in zip(grads, blocks):
            np.testing.assert_allclose(g, r.numpy(), rtol=RTOL, atol=ATOL)


def test_apply_step_and_shard_apply_are_the_optimizers():
    from torchft_tpu_torch import AdamW
    from torchft_tpu_torch.train_state import build_shard_apply_step

    assert par.build_shard_apply_step is build_shard_apply_step
    tx = AdamW(1e-2)
    p = {"w": torch.ones(4)}
    state = tx.init(p)
    out, state = par.build_apply_step(tx)(p, state, {"w": torch.ones(4)})
    assert out is p and state["count"] == 1 and bool((p["w"] < 1).all())
