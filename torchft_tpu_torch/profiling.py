"""Tracing hooks: ``torch.profiler`` spans around the FT transaction.

The runtime's phase boundaries (quorum, reconfigure, collective dispatch,
checkpoint send/recv, commit vote) are annotated with
``torch.profiler.record_function`` spans, so they show up on the host
tracks of a ``torch.profiler`` capture next to the CUDA kernels (the
capture profiles every thread: the quorum runs on its own). A span
with no active capture costs a few microseconds, so the Manager annotates
unconditionally.

Capture is windowed on the manager's step counter, programmatically::

    prof = Profiler(logdir="/tmp/trace", start_step=10, num_steps=5)
    manager = Manager(..., profiler=prof)

or through the environment (``TORCHFT_PROFILE_DIR``,
``TORCHFT_PROFILE_START``, ``TORCHFT_PROFILE_STEPS``). The window is
written as a Chrome trace (``trace.json``) into ``logdir``.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Any, Optional

import torch

logger = logging.getLogger(__name__)

_ENV_DIR = "TORCHFT_PROFILE_DIR"
_ENV_START = "TORCHFT_PROFILE_START"
_ENV_STEPS = "TORCHFT_PROFILE_STEPS"


def span(name: str) -> Any:
    """Named host-track span: ``with span("torchft::quorum"): ...``."""
    return torch.profiler.record_function(name)


def step_span(step: int) -> Any:
    """Step annotation: ``with step_span(step): train_step(...)`` opens a
    ``torchft_step`` span whose argument is the step number, the JAX
    package's ``StepTraceAnnotation("torchft_step", step_num=step)``."""
    return torch.profiler.record_function("torchft_step", args=str(step))


def _all_threads() -> Any:
    """Kineto's all-threads mode: without it a capture records only the
    spans of the thread that started it, and the quorum, reconfigure and
    checkpoint spans the Manager opens on its quorum thread are lost.
    None (with a warning) on a torch build that lacks the mode."""
    try:
        return torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    except (AttributeError, TypeError):
        logger.warning("this torch build cannot profile all threads: spans "
                       "opened off the capturing thread are not traced")
        return None


class Profiler:
    """Windowed ``torch.profiler`` capture keyed on the step counter.

    The capture starts when ``on_step(step)`` first sees
    ``step >= start_step`` and stops ``num_steps`` steps later (or at
    ``shutdown()``). Start/stop failures are logged, never raised:
    profiling must not take down training.
    """

    def __init__(self, logdir: str, start_step: int = 1, num_steps: int = 5) -> None:
        self.logdir = logdir
        self.start_step = start_step
        self.num_steps = num_steps
        self._lock = threading.Lock()
        self._state = "idle"  # idle -> active -> done
        self._stop_after: Optional[int] = None
        self._prof: Optional[torch.profiler.profile] = None

    @classmethod
    def from_env(cls) -> Optional["Profiler"]:
        """Build from the TORCHFT_PROFILE_* variables; None when unset."""
        logdir = os.environ.get(_ENV_DIR)
        if not logdir:
            return None
        return cls(
            logdir,
            start_step=int(os.environ.get(_ENV_START, "1")),
            num_steps=int(os.environ.get(_ENV_STEPS, "5")),
        )

    def on_step(self, step: int) -> None:
        """Advance the capture window; called once per training step."""
        with self._lock:
            if self._state == "idle" and step >= self.start_step:
                self._start(step)
            elif (
                self._state == "active"
                and self._stop_after is not None
                and step >= self._stop_after
            ):
                self._stop()

    def shutdown(self) -> None:
        """Flush an in-flight capture (e.g. at trainer exit)."""
        with self._lock:
            if self._state == "active":
                self._stop()

    @property
    def state(self) -> str:
        return self._state

    # -- internal (lock held) --

    def _start(self, step: int) -> None:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        try:
            self._prof = torch.profiler.profile(
                activities=activities, experimental_config=_all_threads())
            self._prof.__enter__()
        except Exception as e:  # noqa: BLE001 - observability must not kill
            logger.warning("profiler start failed: %s", e)
            self._state = "done"
            return
        self._state = "active"
        # Window from the step the capture actually started at.
        self._stop_after = step + self.num_steps
        logger.info("profiling %d steps to %s", self.num_steps, self.logdir)

    def _stop(self) -> None:
        assert self._prof is not None
        try:
            self._prof.__exit__(None, None, None)
            os.makedirs(self.logdir, exist_ok=True)
            self._prof.export_chrome_trace(
                os.path.join(self.logdir, "trace.json")
            )
        except Exception as e:  # noqa: BLE001
            logger.warning("profiler stop failed: %s", e)
        self._state = "done"
        self._prof = None
        logger.info("profile written to %s", self.logdir)
