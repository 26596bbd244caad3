"""Learning-rate schedules (functions of the step).

Counterpart of ``repro.optim.schedule``: the same arithmetic in f32, on the
step's device, returning a 0-d f32 tensor.
"""

from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
  return torch.as_tensor(step).to(torch.float32)


def cosine_with_warmup(step, *, warmup: int, total: int,
                       min_frac: float = 0.1) -> torch.Tensor:
  """Linear warm-up over ``warmup`` steps, then a cosine from 1 down to
  ``min_frac`` at ``total``."""
  step = _f32(step)
  warm = torch.clamp(step / max(warmup, 1), max=1.0)
  t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
  cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * t))
  return warm * cos


def constant(step, *, value: float = 1.0) -> torch.Tensor:
  return torch.full_like(_f32(step), value)
