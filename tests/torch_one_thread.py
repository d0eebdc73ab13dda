"""Imported by the port's CPU test files: torch runs them on one intra-op
thread. Their tensors are small, so more threads buy them little, and
the cores they would take go to the tests that run beside them (the
tier-1 run spreads over six worker processes on eight cores)."""

import torch

torch.set_num_threads(1)
