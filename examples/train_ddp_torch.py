"""Fault-tolerant data-parallel training demo on PyTorch (the port's
counterpart of ``examples/train_ddp.py``, function by function).

Each replica group (one process here) trains the same model; gradients
are averaged across groups through the manager's fault-tolerant
collectives, and every step ends in a distributed commit vote. Kill any
process: the others keep training, and the restarted process heals from a
live peer.

The trainer runs on the GPU; ``DEVICE=cpu`` runs it on the CPU (without
a GPU and without ``DEVICE=cpu`` it raises). The environment is the JAX
trainer's: ``REPLICA_GROUP_ID``, ``NUM_REPLICA_GROUPS``, ``NUM_STEPS``,
``TORCHFT_LIGHTHOUSE``, ``MODEL=mlp|lm|moe|cnn``,
``DATA=synthetic|digits|cifar10`` (with ``CIFAR_DIR``), ``CKPT_DIR``
and ``CKPT_EVERY``.

Run (2 groups on one machine, CPU)::

    python -m torchft_tpu_torch.lighthouse --min_replicas 1 &
    TORCHFT_LIGHTHOUSE=http://localhost:29510 REPLICA_GROUP_ID=0 \
        DEVICE=cpu python examples/train_ddp_torch.py &
    TORCHFT_LIGHTHOUSE=http://localhost:29510 REPLICA_GROUP_ID=1 \
        DEVICE=cpu python examples/train_ddp_torch.py

or on the GPU under the launcher, with a warmed spare per group::

    python -m torchft_tpu_torch.launcher --num-replica-groups 2 \
        --hot-spare -- python examples/train_ddp_torch.py
"""

import logging
import os
import sys
from datetime import timedelta

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from torchft_tpu_torch import (  # noqa: E402
    AdamW,
    DistributedSampler,
    FTTrainState,
    HostCollectives,
    Manager,
    OptimizerWrapper,
    StatefulDataLoader,
)
from torchft_tpu_torch._device import resolve_device  # noqa: E402
from torchft_tpu_torch._tree import flatten, tree_map, unflatten  # noqa: E402
from torchft_tpu_torch.platform import standby_gate  # noqa: E402

logging.basicConfig(level=logging.INFO)
logger = logging.getLogger("train_ddp")


def make_synthetic_dataset(n: int = 4096, dim: int = 32, classes: int = 10):
    """CIFAR-stand-in: gaussian blobs, deterministic."""
    rng = np.random.default_rng(0)
    centers = rng.standard_normal((classes, dim)).astype(np.float32) * 2
    labels = rng.integers(0, classes, size=n)
    x = centers[labels] + rng.standard_normal((n, dim)).astype(np.float32)
    return x.astype(np.float32), labels.astype(np.int32)


def make_image_dataset():
    """Real-image datasets for MODEL=cnn (no download):

    - ``DATA=digits``: scikit-learn's bundled handwritten-digit images
      (1797 real 8x8 grayscale scans, 10 classes).
    - ``DATA=cifar10``: the standard ``cifar-10-batches-py`` pickle
      batches from ``CIFAR_DIR`` (default ``~/.cache/cifar-10-batches-py``
      — place an already-downloaded copy there; 32x32x3, 10 classes).

    Returns (images NHWC f32 in [0, 1]-ish, labels i32, (H, C, classes)),
    or None for ``DATA=synthetic`` (the caller generates).
    """
    data = os.environ.get("DATA", "synthetic")
    if data == "digits":
        from sklearn.datasets import load_digits

        d = load_digits()
        x = (d.images.astype(np.float32) / 16.0)[..., None]  # (N, 8, 8, 1)
        return x, d.target.astype(np.int32), (8, 1, 10)
    if data == "cifar10":
        import pickle

        cifar_dir = os.environ.get(
            "CIFAR_DIR",
            os.path.expanduser("~/.cache/cifar-10-batches-py"),
        )
        xs, ys = [], []
        for i in range(1, 6):
            path = os.path.join(cifar_dir, f"data_batch_{i}")
            if not os.path.exists(path):
                raise FileNotFoundError(
                    f"{path} not found — DATA=cifar10 needs the standard "
                    "cifar-10-batches-py files in CIFAR_DIR (no network "
                    "in this environment; use DATA=digits for the bundled "
                    "real dataset)"
                )
            with open(path, "rb") as f:
                b = pickle.load(f, encoding="bytes")
            xs.append(np.asarray(b[b"data"], np.uint8))
            ys.append(np.asarray(b[b"labels"], np.int64))
        x = (
            np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
            .astype(np.float32) / 255.0
        )
        return x, np.concatenate(ys).astype(np.int32), (32, 3, 10)
    return None


def init_params(dim: int = 32, hidden: int = 128, classes: int = 10,
                device=None):
    """The MLP's f32 parameters: the JAX trainer's scales, drawn from a
    ``torch.Generator`` seeded 0 (its draws differ from JAX's;
    :func:`params_from_jax` carries JAX's values across)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(0)
    scale = 1.0 / np.sqrt(dim)
    return {
        "w1": (torch.randn((dim, hidden), generator=gen) * scale).to(dev),
        "b1": torch.zeros((hidden,), device=dev),
        "w2": (torch.randn((hidden, classes), generator=gen) * 0.1).to(dev),
        "b2": torch.zeros((classes,), device=dev),
    }


def params_from_jax(np_params, device=None):
    """The JAX trainer's MLP dict (numpy or jax leaves) as f32 tensors on
    ``device``."""
    dev = resolve_device(device)
    return tree_map(
        lambda l: torch.tensor(np.asarray(l, dtype=np.float32), device=dev),
        np_params,
    )


def loss_fn(params, x, y):
    h = torch.relu(x @ params["w1"] + params["b1"])
    logits = h @ params["w2"] + params["b2"]
    return F.cross_entropy(logits, y.long())


def build_model(device=None):
    """MODEL=mlp (default, synthetic blobs), MODEL=cnn (images through
    models.cnn; pick the dataset with DATA=digits|cifar10|synthetic, see
    make_image_dataset), MODEL=lm (the flagship decoder-only transformer,
    tiny config), or MODEL=moe (tiny mixture-of-experts LM on synthetic
    tokens). Returns (params on ``device``, loss(params, x, y), x, y)
    with x and y numpy arrays, as the JAX trainer's."""
    dev = resolve_device(device)
    model = os.environ.get("MODEL", "mlp")
    if model == "lm":
        # the flagship decoder-only transformer family (tiny config for
        # the demo; the card-scale configs are chip_smoke.py's)
        from torchft_tpu_torch.models import (
            TransformerConfig,
            init_params as lm_init,
            loss_fn as lm_loss,
        )

        cfg = TransformerConfig(
            vocab_size=512, d_model=64, n_heads=4, n_layers=2, d_ff=128,
            max_seq_len=64,
        )
        rng = np.random.default_rng(0)
        n, seq = 2048, 33
        x = rng.integers(0, cfg.vocab_size, (n, seq)).astype(np.int32)
        y = np.zeros((n,), np.int32)  # unused: LM loss reads the tokens
        params = lm_init(cfg, seed=0, device=dev)

        def loss(params, xb, yb):
            return lm_loss(cfg, params, xb)

        return params, loss, x, y
    if model == "moe":
        from torchft_tpu_torch.models import moe, tiny_moe_config

        cfg = tiny_moe_config()
        rng = np.random.default_rng(0)
        n, seq = 2048, 33
        x = rng.integers(
            0, cfg.vocab_size, (n, seq), dtype=np.int64
        ).astype(np.int32)
        y = np.zeros((n,), np.int32)  # unused: LM loss reads the tokens
        params = moe.init_params(cfg, seed=0, device=dev)

        def loss(params, xb, yb):
            return moe.loss_fn(cfg, params, xb)

        return params, loss, x, y
    if model == "cnn":
        from torchft_tpu_torch.models import cnn, tiny_cnn_config

        real = make_image_dataset()
        if real is not None:
            x, y, (size, channels, classes) = real
            cfg = cnn.CNNConfig(
                image_size=size,
                channels=channels,
                classes=classes,
                widths=(16, 32) if size <= 8 else (32, 64, 128),
                groups=4,
                dense_width=64,
            )
        else:
            cfg = tiny_cnn_config()
            rng = np.random.default_rng(0)
            n = 2048
            x = rng.standard_normal(
                (n, cfg.image_size, cfg.image_size, cfg.channels)
            ).astype(np.float32)
            y = rng.integers(0, cfg.classes, n).astype(np.int32)
        params = cnn.init_params(cfg, seed=0, device=dev)

        def loss(params, xb, yb):
            return cnn.loss_fn(cfg, params, (xb, yb))

        return params, loss, x, y
    x, y = make_synthetic_dataset()
    return init_params(device=dev), loss_fn, x, y


def value_and_grad(loss):
    """``jax.value_and_grad`` for a loss over a parameter tree:
    ``(params, x, y) -> (loss, grads)``, fresh gradient tensors in the
    tree's structure."""

    def fn(params, xb, yb):
        leaves, treedef = flatten(params)
        work = [l.detach().requires_grad_(True) for l in leaves]
        value = loss(unflatten(treedef, work), xb, yb)
        grads = torch.autograd.grad(value, work)
        return value.detach(), unflatten(treedef, list(grads))

    return fn


def main() -> None:
    replica_group = int(os.environ.get("REPLICA_GROUP_ID", 0))
    num_replica_groups = int(os.environ.get("NUM_REPLICA_GROUPS", 2))
    num_steps = int(os.environ.get("NUM_STEPS", 200))
    batch_size = 64
    device = resolve_device(os.environ.get("DEVICE") or None)

    params0, model_loss_fn, x, y = build_model(device)
    # the dataset lives on the device; a step moves only its indices
    x_dev, y_dev = torch.as_tensor(x).to(device), torch.as_tensor(y).to(device)

    def batch(idx):
        at = torch.as_tensor(np.asarray(idx)).to(device)
        return x_dev[at], y_dev[at]

    sampler = DistributedSampler(
        dataset_len=len(x),
        replica_group=replica_group,
        num_replica_groups=num_replica_groups,
        shuffle=True,
    )

    # Dataloader position is part of the recovery state: a healed replica
    # resumes its shard mid-epoch instead of re-deriving an offset from the
    # step count.
    loader = StatefulDataLoader(sampler, batch_size)

    state = FTTrainState(params0, AdamW(1e-3))

    # Checkpoints (recovery or durable) must pair step-N weights with the
    # loader position AS OF the last commit — not the live position, which
    # is already past the in-flight, possibly-never-committed batch.
    ckpt_box = {"loader": loader.state_dict(), "healed": False}

    def full_state_dict():
        return {"train": state.state_dict(), "loader": ckpt_box["loader"]}

    def load_full_state_dict(sd):
        state.load_state_dict(sd["train"])
        loader.load_state_dict(sd["loader"])
        ckpt_box["loader"] = dict(sd["loader"])
        ckpt_box["healed"] = True

    grad_fn = value_and_grad(model_loss_fn)
    # One forward+backward on the device, then park if we are a hot-spare
    # standby (launcher --hot-spare): a promoted standby has paid the
    # interpreter, the imports, the CUDA context and its first launches.
    warm_idx = next(iter(StatefulDataLoader(sampler, batch_size)))
    grad_fn(state.params, *batch(warm_idx))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    standby_gate()

    collectives = HostCollectives(timeout=timedelta(seconds=30))
    manager = Manager(
        collectives=collectives,
        load_state_dict=load_full_state_dict,
        state_dict=full_state_dict,
        min_replica_size=1,
        replica_id=f"train_ddp_{replica_group}",
        device=device,
    )
    optimizer = OptimizerWrapper(manager, state)

    # Durable tier (CKPT_DIR set): periodic whole-job checkpoints pairing
    # the user state with the manager's {step, batches_committed} AND the
    # loader position; restore BEFORE the first quorum so the replica
    # rejoins at its step instead of 0.
    ckpt = None
    if os.environ.get("CKPT_DIR"):
        from torchft_tpu_torch import DurableCheckpointer

        class _UserState:
            state_dict = staticmethod(full_state_dict)
            load_state_dict = staticmethod(load_full_state_dict)

        ckpt = DurableCheckpointer(
            os.environ["CKPT_DIR"],
            manager,
            _UserState(),
            every=int(os.environ.get("CKPT_EVERY", 50)),
            device=device,
        )
        restored = ckpt.restore_latest()
        if restored is not None:
            logger.info(
                f"[group {replica_group}] restored durable ckpt at "
                f"step {restored}"
            )

    while manager.current_step() < num_steps:
        step = manager.current_step()
        ckpt_box["healed"] = False
        loader_ckpt = loader.state_dict()
        bx, by = batch(next(loader))

        optimizer.zero_grad()  # async quorum, overlapped with fwd/bwd
        loss, grads = grad_fn(state.params, bx, by)
        avg_grads = manager.allreduce(grads).wait()
        committed = optimizer.step(avg_grads)
        if committed:
            if ckpt_box["healed"]:
                # The heal restored the source's position as of ITS last
                # commit; this step's commit adds one more. Skip one batch
                # (zero-contributed while healing, lossy by design) so
                # position stays aligned with the committed-step count and
                # epoch boundaries stay synchronized across replica groups.
                next(loader)
            ckpt_box["loader"] = loader.state_dict()
            if ckpt is not None:
                ckpt.maybe_save()
        elif not ckpt_box["healed"]:
            # Replay the same batch on the retry: an uncommitted step must
            # not advance the durable data position, or the stream drifts
            # from the committed-step count and the batch is lost. (A heal
            # applied this step already reset the loader to the peer's
            # committed position — rolling back would clobber it.)
            loader.load_state_dict(loader_ckpt)

        if step % 10 == 0:
            logger.info(
                f"[group {replica_group}] step={step} loss={float(loss):.4f} "
                f"participants={manager.num_participants()} "
                f"committed={committed}"
            )
    logger.info(
        f"[group {replica_group}] done: step={manager.current_step()} "
        f"batches_committed={manager.batches_committed()}"
    )
    if ckpt is not None:
        # drain the async writer: the last snapshot's manifest commit
        # must land before the process exits
        ckpt.flush()
        ckpt.close()
    manager.shutdown()
    collectives.shutdown()


if __name__ == "__main__":
    main()
