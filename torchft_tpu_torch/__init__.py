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
runtime strategy policy (``PolicyEngine``). Imports neither JAX nor
``torchft_tpu``.

Entry points run on the card unless given ``device="cpu"``.
"""

from .checkpointing import CheckpointServer, CheckpointTransport
from .collectives import (
    Collectives,
    DummyCollectives,
    HostCollectives,
    ReduceOp,
    TreeShard,
    Work,
)
from .data import DistributedSampler, StatefulDataLoader
from .durable import (
    CheckpointStore,
    DurableCheckpointer,
    LocalDirStore,
    ManifestLog,
)
from .ddp import AdaptiveDDP, DistributedDataParallel, PipelinedDDP, ShardedDDP
from .local_sgd import AsyncDiLoCo, DiLoCo, LocalSGD
from .chaos import ChaosInjector, FaultEvent, FaultPlan
from .manager import Manager, WorldSizeMode
from .metrics import Metrics
from .optim import OptimizerWrapper, ShardedOptimizerWrapper
from .policy import CostKnobs, PolicyEngine, StrategySpec
from .parameter_server import ParameterServer
from .profiling import Profiler, span
from .serving import (
    StaleWeightsError,
    WeightPublisher,
    WeightRelay,
    WeightSubscriber,
)
from .train_state import SGD, AdamW, FTTrainState
from ._native import (
    LeaseClient,
    Lighthouse,
    ManagerClient,
    QuorumResult,
    RegionLighthouse,
    Store,
    StoreClient,
    WireCorruption,
)

__all__ = [
    "AdamW",
    "AdaptiveDDP",
    "AsyncDiLoCo",
    "ChaosInjector",
    "CheckpointServer",
    "CheckpointStore",
    "CheckpointTransport",
    "Collectives",
    "CostKnobs",
    "DiLoCo",
    "DistributedDataParallel",
    "DistributedSampler",
    "DummyCollectives",
    "DurableCheckpointer",
    "FTTrainState",
    "FaultEvent",
    "FaultPlan",
    "HostCollectives",
    "LeaseClient",
    "Lighthouse",
    "LocalDirStore",
    "LocalSGD",
    "Manager",
    "ManagerClient",
    "ManifestLog",
    "Metrics",
    "OptimizerWrapper",
    "ParameterServer",
    "PipelinedDDP",
    "PolicyEngine",
    "Profiler",
    "QuorumResult",
    "ReduceOp",
    "RegionLighthouse",
    "SGD",
    "ShardedDDP",
    "ShardedOptimizerWrapper",
    "StaleWeightsError",
    "StatefulDataLoader",
    "Store",
    "StoreClient",
    "StrategySpec",
    "TreeShard",
    "WeightPublisher",
    "WeightRelay",
    "WeightSubscriber",
    "WireCorruption",
    "Work",
    "WorldSizeMode",
    "span",
]
