"""Package-level contracts of the PyTorch port.

The port imports neither JAX nor the JAX package (it keeps its own copy
of everything it needs), and importing it builds nothing and starts no
process: the native library and the CUDA kernels build at first use. Its
heal wire carries numpy arrays through its own safelisted unpickler.
"""

import io
import os
import pickle
import subprocess
import sys
import urllib.error
import urllib.request
from datetime import timedelta

import numpy as np
import pytest
import torch

import torch_one_thread  # noqa: F401

from torchft_tpu_torch import checkpointing as ck

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_import_pulls_in_neither_jax_nor_torchft_tpu():
    code = (
        "import sys, torchft_tpu_torch, torchft_tpu_torch.models, "
        "torchft_tpu_torch.ops, torchft_tpu_torch.lighthouse, "
        "torchft_tpu_torch.collectives, torchft_tpu_torch.manager, "
        "torchft_tpu_torch.ddp, torchft_tpu_torch.profiling, chip_smoke\n"
        "import torchft_tpu_torch.quantize, torchft_tpu_torch.optim, "
        "torchft_tpu_torch.train_state, torchft_tpu_torch.local_sgd\n"
        "from torchft_tpu_torch import (AdaptiveDDP, AsyncDiLoCo, DiLoCo, "
        "LocalSGD, SGD)\n"
        "from torchft_tpu_torch.models import make_train_step\n"
        "import torchft_tpu_torch.checkpointing, "
        "torchft_tpu_torch.models.transformer, "
        "torchft_tpu_torch.ops.flash_attention\n"
        "import torchft_tpu_torch.durable, torchft_tpu_torch.serving, "
        "torchft_tpu_torch.parameter_server\n"
        "from torchft_tpu_torch import (DurableCheckpointer, ParameterServer, "
        "StaleWeightsError, WeightPublisher, WeightRelay, WeightSubscriber)\n"
        "import torchft_tpu_torch.platform, torchft_tpu_torch.launcher, "
        "torchft_tpu_torch.chaos, torchft_tpu_torch.policy\n"
        "from torchft_tpu_torch import (ChaosInjector, CostKnobs, FaultPlan, "
        "LeaseClient, PolicyEngine, RegionLighthouse, StrategySpec, "
        "WorldSizeMode)\n"
        "from torchft_tpu_torch._native import (WalLog, wal_recover, "
        "fault_arm, quorum_step, lighthouse_heartbeat, ShmSegment, "
        "shm_layout)\n"
        "import torchft_tpu_torch.xla_collectives, "
        "torchft_tpu_torch.isolated_xla\n"
        "from torchft_tpu_torch import (ChildDiedError, ChildStalledError, "
        "IsolatedXLACollectives, XLACollectives)\n"
        "import torchft_tpu_torch.parallel, torchft_tpu_torch.pipeline, "
        "torchft_tpu_torch.context_parallel, torchft_tpu_torch.models.moe, "
        "torchft_tpu_torch.models.cnn\n"
        "from torchft_tpu_torch import Mesh, make_mesh, pipeline_blocks\n"
        "from torchft_tpu_torch.models import (CNNConfig, MoEConfig, cnn, moe, "
        "param_sharding_rules)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'optax', 'ml_dtypes', 'torchft_tpu'))\n"
        "assert not bad, bad\n"
        "from torchft_tpu_torch import _native\n"
        "assert _native._lib._cdll is None, 'import loaded the native library'\n"
        "from torchft_tpu_torch.ops import quantize_kernels as qk\n"
        "assert qk._kernels._lib is None, 'import loaded the kernels'\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr


def test_no_source_file_names_jax():
    pkg = os.path.join(REPO, "torchft_tpu_torch")
    offenders = []
    for root, _, files in os.walk(pkg):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(root, name)
            with open(path) as f:
                for n, line in enumerate(f, 1):
                    s = line.strip()
                    if s.startswith(("import jax", "from jax", "import optax",
                                     "from optax", "import ml_dtypes",
                                     "from ml_dtypes",
                                     "from torchft_tpu ", "from torchft_tpu.",
                                     "import torchft_tpu ", "import torchft_tpu.")):
                        offenders.append(f"{path}:{n}: {s}")
    assert not offenders, offenders


def test_checkpoint_wire_is_numpy_through_a_safelist():
    """The pickled heal paths carry tensors as numpy arrays through the
    port's safelisted unpickler (the streamed heal, the default, hands
    back tensors on the receiver's device, its skeleton through the same
    safelist); a pickle that names a function is refused."""
    server = ck.CheckpointServer(timeout=timedelta(seconds=10), device="cpu")
    try:
        state = {"user": {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
                          "count": 3},
                 "torchft": {"step": 7, "batches_committed": 14}}
        server.send_checkpoint([1], 7, state, timedelta(seconds=10))
        with urllib.request.urlopen(f"{server.metadata()}7", timeout=10) as f:
            pickled = ck.load_state_dict_stream(f)
        assert isinstance(pickled["user"]["w"], np.ndarray)
        assert pickled["user"]["w"].tobytes() == state["user"]["w"].numpy().tobytes()
        got = server.recv_checkpoint(0, server.metadata(), 7, timedelta(seconds=10))
        assert server.last_fetch_stats["path"] == "stream"
        assert isinstance(got["user"]["w"], torch.Tensor)
        assert got["user"]["w"].device.type == "cpu"
        assert got["user"]["w"].numpy().tobytes() == state["user"]["w"].numpy().tobytes()
        assert got["user"]["count"] == 3 and got["torchft"]["step"] == 7
        with pytest.raises(urllib.error.HTTPError) as e:
            server.recv_checkpoint(0, server.metadata(), 6, timedelta(seconds=10))
        assert e.value.code == 400
    finally:
        server.shutdown()

    class Evil:
        def __reduce__(self):
            return (os.system, ("true",))

    with pytest.raises(pickle.UnpicklingError):
        ck.load_state_dict_stream(io.BytesIO(pickle.dumps(Evil())))
