"""Gradient compression for slow links: int8 with error feedback.

Counterpart of ``repro.optim.compression``: ``ef_int8_roundtrip``, the
wire-format transform the trainer applies to the gradients with
``--compress-grads`` (quantize to int8 with one scale a leaf, dequantize,
carry the rounding error to the next step), and ``init_residual``.  The
reference's ``pod_psum_int8`` is a ``shard_map`` collective over the
'pod' mesh axis; it waits for the port's sharding and raises here.
"""

from __future__ import annotations

import torch

from repro_torch.models.layers import not_ported


def _quant_int8(x: torch.Tensor):
  amax = torch.max(torch.abs(x)) + 1e-12
  scale = amax / 127.0
  q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
  return q, scale


def _dequant(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
  return q.to(torch.float32) * scale


def ef_int8_roundtrip(grads: dict, residual: dict) -> tuple[dict, dict]:
  """Error-feedback int8 round trip over a dict of gradients.

  Returns (decoded grads, new residual), both keyed and typed like
  ``grads``; ``residual`` holds the last step's rounding errors.
  """
  decoded, new_resid = {}, {}
  for name, g in grads.items():
    g32 = g.to(torch.float32) + residual[name].to(torch.float32)
    dec = _dequant(*_quant_int8(g32))
    decoded[name] = dec.to(g.dtype)
    new_resid[name] = (g32 - dec).to(g.dtype)
  return decoded, new_resid


def init_residual(like: dict) -> dict:
  """Zero residuals, keyed, shaped and typed like ``like``."""
  return {name: torch.zeros_like(t) for name, t in like.items()}


def pod_psum_int8(*args, **kwargs):
  raise not_ported("pod_psum_int8 (the int8 all-reduce over the 'pod' "
                   "mesh axis)", "sharding/")
