"""Soft top-k router gate: the CUDA kernel and its plain version.

Counterpart of ``repro.kernels.soft_topk``.  Per row of logits (T, E), the
projection of logits/eps onto the k-subset permutahedron (the paper's soft
top-k, forward only): gates in [0, 1] with row sum k.

* ``soft_topk_gates``: on a CUDA tensor, the hand-written kernel in
  ``csrc/soft_topk.cu`` (one warp per row; see the note there); on a CPU
  tensor, the plain version.  It computes in f32 and returns the input's
  dtype, like the Pallas wrapper.  Each kernel launch adds one to
  ``LAUNCHES["soft_topk_gates"]``.
* ``soft_topk_gates_plain``: sort -> ``pav_l2_stack`` -> un-sort in plain
  PyTorch, on any device.  It runs the kernel's isotonic arithmetic, and
  on the card its division by eps is, as in the kernel, a product with
  the f32 reciprocal of eps, so there the two agree to the last bit on the
  same f32 logits for every eps.  (The CPU divides: for an eps that is not
  a power of two, z and so the gates may differ there by an ulp.)

``repro_torch.kernels.ref.soft_topk_gates_ref`` (minimax closed form) is
the independent oracle.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.pav import pav_l2_stack

# Launch count of the kernel; only the wrapper below increments it.
LAUNCHES = {"soft_topk_gates": 0}
MAX_EXPERTS = 128


def reset_launches() -> None:
  LAUNCHES["soft_topk_gates"] = 0


def _next_pow2(n: int) -> int:
  p = 1
  while p < n:
    p *= 2
  return p


def _check(logits: torch.Tensor, k: int) -> None:
  if not logits.is_floating_point():
    raise TypeError(f"soft_topk_gates takes floating logits; got "
                    f"{logits.dtype}")
  if logits.dim() != 2:
    raise ValueError(f"soft_topk_gates takes (T, E) logits; got shape "
                     f"{tuple(logits.shape)}")
  e = logits.shape[1]
  if not 1 <= e <= MAX_EXPERTS:
    raise ValueError(f"soft_topk_gates takes 1 <= E <= {MAX_EXPERTS}; "
                     f"got E = {e}")
  if not 0 <= k <= e:
    raise ValueError(f"soft_topk_gates takes 0 <= k <= E; got k = {k}, "
                     f"E = {e}")


def soft_topk_gates_plain(logits: torch.Tensor, k: int,
                          regularization_strength: float = 1.0
                          ) -> torch.Tensor:
  """Plain version: (T, E) -> (T, E) gates, on the input's device."""
  _check(logits, k)
  z = logits.to(torch.float32) / regularization_strength
  e = z.shape[1]
  w = torch.zeros((e,), dtype=z.dtype, device=z.device)
  w[:k] = 1
  sigma = torch.argsort(-z, dim=-1, stable=True)
  s = torch.gather(z, 1, sigma)
  v = pav_l2_stack(s - w)
  out = torch.empty_like(s).scatter_(1, sigma, s - v)
  return out.to(logits.dtype)


def soft_topk_gates(logits: torch.Tensor, k: int,
                    regularization_strength: float = 1.0) -> torch.Tensor:
  """Fused soft top-k gate mass for each row of ``logits`` (T, E).

  Gates in [0, 1]^E summing to k per row.  A CUDA tensor runs the kernel;
  a CPU tensor the plain version; any other device raises.
  """
  if logits.device.type == "cpu":
    return soft_topk_gates_plain(logits, k, regularization_strength)
  if logits.device.type != "cuda":
    raise ValueError(f"soft_topk_gates takes CPU or CUDA tensors; got "
                     f"{logits.device}")
  _check(logits, k)
  z = logits.to(torch.float32).contiguous()
  rows, e = z.shape
  out = torch.empty_like(z)
  if rows == 0:
    return out.to(logits.dtype)
  launch = _build.entry("soft_topk", "soft_topk_launch", [
      ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
      ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
  with _build.on_device(z.device):
    err = launch(z.data_ptr(), out.data_ptr(), rows, e,
                 _next_pow2(max(e, 2)), k, float(regularization_strength),
                 _build.current_stream(z.device))
  if err != 0:
    raise RuntimeError(f"soft_topk_gates kernel launch failed with CUDA "
                       f"error {err}")
  LAUNCHES["soft_topk_gates"] += 1
  return out.to(logits.dtype)
