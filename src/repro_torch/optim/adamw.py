"""AdamW over a dict of parameters, updated in place.

Counterpart of ``repro.optim.adamw``:

* moments in ``moment_dtype`` (f32 by default; bf16 for the largest
  configurations), the update itself in f32 and cast back to each
  parameter's dtype;
* clipping by the global gradient norm;
* soft-quantile clipping (the paper's operator, off by default): the clip
  threshold is the soft q-quantile of the recent grad-norm history, by
  the port's ``core.soft_quantile`` (on the card, the PAV kernel).

Parameters, gradients and moments are dicts keyed alike (the model's
``named_parameters`` names).  Where the reference returns new parameters
and state, the port writes them in place, one leaf at a time, so only one
leaf's f32 temporaries are alive at once (0.74 GB for an expert leaf of
deepseek-v2-lite-16b); ``update`` returns the same objects.  The state is
``{"step": int32, "m": {...}, "v": {...}}`` plus ``"norm_history"`` when
the soft-quantile clip is on.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.operators import soft_quantile


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
  lr: float = 3e-4
  b1: float = 0.9
  b2: float = 0.95
  eps: float = 1e-8
  weight_decay: float = 0.1
  clip_norm: float = 1.0
  moment_dtype: str = "float32"
  # soft-quantile adaptive clipping (0 disables; else quantile in (0,1))
  quantile_clip: float = 0.0
  quantile_window: int = 64
  quantile_eps: float = 0.05


def _device(tree: dict) -> torch.device:
  return next(iter(tree.values())).device if tree else torch.device("cpu")


def init(cfg: AdamWConfig, params: dict) -> dict:
  mdt = getattr(torch, cfg.moment_dtype)
  state = {
      "step": torch.zeros((), dtype=torch.int32, device=_device(params)),
      "m": {n: torch.zeros_like(p, dtype=mdt) for n, p in params.items()},
      "v": {n: torch.zeros_like(p, dtype=mdt) for n, p in params.items()},
  }
  if cfg.quantile_clip > 0:
    state["norm_history"] = torch.full(
        (cfg.quantile_window,), cfg.clip_norm, dtype=torch.float32,
        device=_device(params))
  return state


def global_norm(tree: dict) -> torch.Tensor:
  """sqrt of the sum of squares of every leaf, in f32."""
  return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                        for x in tree.values()))


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
  """The correctly rounded square root of an f32 tensor, in f32.

  PyTorch's f32 square root on the card is not correctly rounded
  (``chip_smoke.py`` counts where it differs from the CPU's).  The square
  root of the f64 value rounded once to f32 is (53 >= 2 * 24 + 2 bits), so
  the root is taken in f64 and written straight into an f32 tensor: on
  the card one f64 copy of ``x`` is made and the f64 root is never stored.
  """
  return torch.sqrt(x.to(torch.float64), out=torch.empty_like(x))


def update_leaf(cfg: AdamWConfig, p, g, m, v, scale, lr, bc1, bc2,
                decay: bool):
  """One leaf's step in f32: (new p, new m, new v) before any cast.

  The reference's operations in its order, each correctly rounded on the
  card as on the CPU, so the two agree bit for bit: ``scale``, ``lr``,
  ``bc1`` and ``bc2`` are 0-d f32 tensors on the leaf's device (a division
  by a Python number is a product with its reciprocal on the card), and
  the square root is ``sqrt_rn``.
  """
  b1, b2 = cfg.b1, cfg.b2
  g32 = g.to(torch.float32) * scale
  m32 = b1 * m.to(torch.float32) + (1 - b1) * g32
  v32 = b2 * v.to(torch.float32) + (1 - b2) * g32 * g32
  root = sqrt_rn(v32 / bc2)
  step = (m32 / bc1) / (root + cfg.eps)
  if decay:
    step = step + cfg.weight_decay * p.to(torch.float32)
  return p.to(torch.float32) - lr * step, m32, v32


@torch.no_grad()
def update(cfg: AdamWConfig, grads: dict, state: dict, params: dict,
           lr_scale: torch.Tensor | float = 1.0,
           decay: dict[str, bool] | None = None):
  """Returns (params, state, metrics), params and state updated in place.

  ``decay`` says which leaves take weight decay, by name; by default the
  leaves of ndim >= 2, the reference's rule on its own layouts.
  """
  device = _device(params)
  step = state["step"] + 1
  gnorm = global_norm(grads)

  if cfg.quantile_clip > 0:
    hist = state["norm_history"]
    clip = soft_quantile(hist, cfg.quantile_clip, cfg.quantile_eps)
    clip = torch.clamp(clip, min=1e-6)
    state["norm_history"] = torch.cat([hist[1:], gnorm.reshape(1)])
  else:
    clip = torch.tensor(cfg.clip_norm, dtype=torch.float32, device=device)
  scale = torch.clamp(clip / torch.clamp(gnorm, min=1e-12), max=1.0)

  lr = cfg.lr * torch.as_tensor(lr_scale, dtype=torch.float32,
                                device=device)
  bc1 = 1.0 - cfg.b1 ** step.to(torch.float32)
  bc2 = 1.0 - cfg.b2 ** step.to(torch.float32)
  for name, p in params.items():
    m, v = state["m"][name], state["v"][name]
    new_p, m32, v32 = update_leaf(
        cfg, p, grads[name], m, v, scale, lr, bc1, bc2,
        p.dim() >= 2 if decay is None else decay[name])
    p.copy_(new_p)
    m.copy_(m32)
    v.copy_(v32)
    del new_p, m32, v32
  state["step"] = step
  metrics = {"grad_norm": gnorm, "clip_scale": scale, "clip_at": clip}
  return params, state, metrics
