"""Builds the port's native pieces at first use, into ``_build/``.

Two products, both compiled from sources in the checkout:

- ``_libtorchft.so``: the native control plane (lighthouse, manager
  service, store, ring and CommPlan collectives), built from ``native/``
  with its own Makefile. The JAX package builds the same sources into its
  own directory, so the two packages speak one wire protocol.
- ``libtft_kernels.so``: the hand-written CUDA kernels of ``csrc/``,
  compiled by ``nvcc`` for ``sm_90a`` with a plain C interface (bound with
  ctypes, no PyTorch headers): one ``nvcc -c`` per source, all started
  together, then one link.

Each product's build is serialised across processes with an exclusive
``flock`` on its own lock file in ``_build/``: test workers and
replica-group processes that start together build once and load the same
file, while the two products may build at the same time.
"""

from __future__ import annotations

import contextlib
import fcntl
import os
import subprocess
from typing import Iterator, List

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NATIVE_SRC = os.path.join(os.path.dirname(PKG_DIR), "native")
NATIVE_LIB = os.path.join(BUILD_DIR, "_libtorchft.so")
KERNEL_SOURCES = [
    os.path.join(PKG_DIR, "csrc", name)
    for name in ("quantize_kernels.cu", "flash_attention.cu")
]
KERNEL_LIB = os.path.join(BUILD_DIR, "libtft_kernels.so")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]


@contextlib.contextmanager
def _locked(product: str) -> Iterator[None]:
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, f".lock-{product}"), "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


# Toolchain variables an environment may set. The native Makefile reads
# them with ?=, so they would replace its compiler and flags: with CXX
# pointing at another gcc install, the library came out carrying its own
# libstdc++, which fought the process's shared one over locale facets (a
# null facet, and a segfault, at the first numeric ostream insert). The
# build uses the system toolchain the Makefile names instead.
_TOOLCHAIN_ENV = ("CC", "CXX", "CFLAGS", "CXXFLAGS", "CPPFLAGS", "LDFLAGS",
                  "LDLIBS", "EXTRA_CXXFLAGS")


def _run_all(cmds: List[List[str]], log_name: str) -> None:
    """Runs the commands at once; logs each one's output (in order) to
    ``log_name`` and raises if any failed."""
    env = {k: v for k, v in os.environ.items() if k not in _TOOLCHAIN_ENV}
    procs = [
        subprocess.Popen(cmd, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True, env=env)
        for cmd in cmds
    ]
    outs = [p.communicate()[0] for p in procs]
    with open(os.path.join(BUILD_DIR, log_name), "w") as log:
        for cmd, out in zip(cmds, outs):
            log.write(" ".join(cmd) + "\n" + out)
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(
                f"build failed ({' '.join(cmd[:3])} ...), exit "
                f"{p.returncode}:\n{out[-4000:]}"
            )


def _run(cmd: List[str], log_name: str) -> None:
    _run_all([cmd], log_name)


def build_native() -> str:
    """Builds (or brings up to date) the native control plane; returns
    the library's path. ``make`` decides what is stale."""
    if not os.path.isdir(NATIVE_SRC):
        raise RuntimeError(
            f"native sources not found at {NATIVE_SRC}: the port builds its "
            "control plane from the repository's native/ directory"
        )
    with _locked("native"):
        _run(
            [
                "make", "-C", NATIVE_SRC, "-j",
                # The hand-rolled wire-compatible protobuf header, never
                # libprotobuf: a process that also loads the JAX package's
                # library (tests, mixed fleets) would otherwise register
                # torchft.proto twice in protobuf's global pool and abort.
                "HAVE_PROTOC=0",
                f"OUT={NATIVE_LIB}",
                f"BUILD={os.path.join(BUILD_DIR, 'native')}",
            ],
            "native_build.log",
        )
    return NATIVE_LIB


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError(
            "nvcc not found (no CUDA_HOME): the CUDA kernels are built from "
            "csrc/ on a machine with the CUDA toolkit"
        )
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build_kernels() -> str:
    """Compiles ``csrc/*.cu`` into one shared library unless it is newer
    than every source; returns its path. The sources compile in parallel;
    the ptxas report (registers, shared memory, spills) lands in
    ``_build/kernels_build.log``."""
    with _locked("kernels"):
        stale = not os.path.exists(KERNEL_LIB) or any(
            os.path.getmtime(src) > os.path.getmtime(KERNEL_LIB)
            for src in KERNEL_SOURCES
        )
        if stale:
            nvcc = _nvcc()
            objs = [
                os.path.join(BUILD_DIR, os.path.basename(src)[:-3] + ".o")
                for src in KERNEL_SOURCES
            ]
            _run_all(
                [[nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", obj, src]
                 for src, obj in zip(KERNEL_SOURCES, objs)],
                "kernels_build.log",
            )
            tmp = KERNEL_LIB + ".tmp"
            _run([nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs],
                 "kernels_link.log")
            os.replace(tmp, KERNEL_LIB)
    return KERNEL_LIB
