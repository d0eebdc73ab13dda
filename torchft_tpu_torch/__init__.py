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
it. Imports neither JAX nor ``torchft_tpu``.

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
from .manager import Manager
from .metrics import Metrics
from .optim import OptimizerWrapper, ShardedOptimizerWrapper
from .parameter_server import ParameterServer
from .profiling import Profiler, span
from .serving import (
    StaleWeightsError,
    WeightPublisher,
    WeightRelay,
    WeightSubscriber,
)
from .train_state import SGD, AdamW, FTTrainState
from ._native import Lighthouse, ManagerClient, Store, StoreClient

__all__ = [
    "AdamW",
    "AdaptiveDDP",
    "AsyncDiLoCo",
    "CheckpointServer",
    "CheckpointTransport",
    "CheckpointStore",
    "Collectives",
    "DiLoCo",
    "DistributedDataParallel",
    "DistributedSampler",
    "DummyCollectives",
    "DurableCheckpointer",
    "FTTrainState",
    "HostCollectives",
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
    "Profiler",
    "ReduceOp",
    "SGD",
    "ShardedDDP",
    "ShardedOptimizerWrapper",
    "StaleWeightsError",
    "StatefulDataLoader",
    "Store",
    "StoreClient",
    "TreeShard",
    "WeightPublisher",
    "WeightRelay",
    "WeightSubscriber",
    "Work",
    "span",
]
