"""Gradient compression for slow links: int8 with error feedback.

Counterpart of ``repro.optim.compression``: ``ef_int8_roundtrip``, the
wire-format transform the trainer applies to the gradients with
``--compress-grads`` (quantize to int8 with one scale a leaf, dequantize,
carry the rounding error to the next step), ``init_residual``, and
``pod_psum_int8``, the all-reduce over the 'pod' mesh axis.
"""

from __future__ import annotations

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor

from repro_torch.sharding import local as _local
from repro_torch.sharding import specs as _specs


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


def pod_psum_int8(x: DTensor, mesh, spec) -> DTensor:
  """The sum over the 'pod' mesh axis of each device's int8 round trip of
  its own block of ``x`` laid out by ``spec``.

  What the reference computes (``repro.optim.compression.pod_psum_int8``,
  whose docstring promises an int8 wire): each device quantizes its own
  block to int8 with its own amax scale and dequantizes it, and the
  decoded f32 values are summed over 'pod' (a functional all-reduce) and
  cast back to ``x``'s dtype.  So the wire carries the decoded f32 values,
  not int8.  The result has ``spec``'s layout, each device holding the sum
  of its block and its pod peers'.
  """
  want = _specs.placements(mesh, spec)
  x = _local.to_placements(x, want)
  local = x.to_local()
  dec = _dequant(*_quant_int8(local))
  summed = funcol.all_reduce(dec, "sum", (mesh, mesh.mesh_dim_names.index(
      "pod")))
  return DTensor.from_local(funcol.wait_tensor(summed).to(local.dtype), mesh,
                            want, shape=x.shape, stride=x.stride())
