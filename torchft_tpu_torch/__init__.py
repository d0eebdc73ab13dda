"""torchft_tpu_torch: per-step fault-tolerant training for PyTorch on
NVIDIA Hopper.

The PyTorch/CUDA port of ``torchft_tpu``. Each training step is a
transaction — quorum, forward/backward, fault-tolerant gradient sync,
commit vote, heal from a live peer — over the same native control plane
the JAX package binds (built from ``native/`` at first use), so replica
groups of both packages can share a quorum and a ring. The gradient
sync's wire encoding runs on the card through hand-written CUDA kernels
(``ops``). Around the step: the durable checkpoint tier
(``DurableCheckpointer``), the weight-serving plane (``WeightPublisher``
/ ``WeightRelay`` / ``WeightSubscriber``) and the parameter server on
it; the durable control plane (WAL-backed roots with warm standbys, the
region tier), the launcher with hot spares (``launcher``,
``platform.standby_gate``), the seeded chaos plane (``chaos``) and the
runtime strategy policy (``PolicyEngine``); the second data plane, a
torch process group rebuilt per quorum (``XLACollectives``), and its
disposable-child form (``IsolatedXLACollectives``); intra-group
parallelism over a mesh of processes (``parallel``: tensor, data,
``context_parallel``, ``pipeline``, and the MoE and CNN families in
``models``), each rank of a group with its own ``Manager``. Imports
neither JAX nor ``torchft_tpu``.

Entry points run on the card unless given ``device="cpu"``.
"""

from __future__ import annotations

import importlib
from typing import Any, List

# Each public name and the module that defines it, imported at first use:
# the control-plane entry points (``python -m torchft_tpu_torch.lighthouse``,
# ``.launcher``, ``platform.standby_gate``) need no torch, and a process
# that runs only them starts without importing it.
_EXPORTS = {
    "AdamW": "train_state",
    "AdaptiveDDP": "ddp",
    "AsyncDiLoCo": "local_sgd",
    "ChaosInjector": "chaos",
    "CheckpointServer": "checkpointing",
    "CheckpointStore": "durable",
    "CheckpointTransport": "checkpointing",
    "ChildDiedError": "isolated_xla",
    "ChildStalledError": "isolated_xla",
    "Collectives": "collectives",
    "CostKnobs": "policy",
    "DiLoCo": "local_sgd",
    "DistributedDataParallel": "ddp",
    "DistributedSampler": "data",
    "DummyCollectives": "collectives",
    "DurableCheckpointer": "durable",
    "FTTrainState": "train_state",
    "FaultEvent": "chaos",
    "FaultPlan": "chaos",
    "HostCollectives": "collectives",
    "IsolatedXLACollectives": "isolated_xla",
    "LeaseClient": "_native",
    "Lighthouse": "_native",
    "LocalDirStore": "durable",
    "LocalSGD": "local_sgd",
    "Manager": "manager",
    "ManagerClient": "_native",
    "ManifestLog": "durable",
    "Mesh": "parallel",
    "Metrics": "metrics",
    "OptimizerWrapper": "optim",
    "ParameterServer": "parameter_server",
    "PipelinedDDP": "ddp",
    "PolicyEngine": "policy",
    "Profiler": "profiling",
    "QuorumResult": "_native",
    "ReduceOp": "collectives",
    "RegionLighthouse": "_native",
    "SGD": "train_state",
    "ShardedDDP": "ddp",
    "ShardedOptimizerWrapper": "optim",
    "StaleWeightsError": "serving",
    "StatefulDataLoader": "data",
    "Store": "_native",
    "StoreClient": "_native",
    "StrategySpec": "policy",
    "TreeShard": "collectives",
    "WeightPublisher": "serving",
    "WeightRelay": "serving",
    "WeightSubscriber": "serving",
    "WireCorruption": "_native",
    "Work": "collectives",
    "WorldSizeMode": "manager",
    "XLACollectives": "xla_collectives",
    "make_mesh": "parallel",
    "pipeline_blocks": "pipeline",
    "span": "profiling",
    "stack_blocks": "pipeline",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str) -> Any:
    """A public name, or a submodule, on first access."""
    module = _EXPORTS.get(name)
    if module is not None:
        value = getattr(importlib.import_module(f".{module}", __name__), name)
        globals()[name] = value
        return value
    try:
        return importlib.import_module(f".{name}", __name__)
    except ModuleNotFoundError as e:
        if e.name != f"{__name__}.{name}":
            raise
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__() -> List[str]:
    return sorted(set(globals()) | set(__all__))
