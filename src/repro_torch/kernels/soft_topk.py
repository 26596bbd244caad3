"""Soft top-k router gate: the CUDA kernel and its plain version.

Counterpart of ``repro.kernels.soft_topk``.  Per row of logits (T, E), the
projection of logits/eps onto the k-subset permutahedron (the paper's soft
top-k, forward only): gates in [0, 1] with row sum k.

After the descending sort, y = s - w with w = (1^k, 0^(E-k)) is
non-increasing on [0, k) and again on [k, E), so its isotonic fit is one
merge of those two solved segments: at most one pool, grown from the pair
k - 1, k by the rules of ``pav_scan._merge_level`` (strict ``<``, both
sides of a step decided against one pool value, sums only added).  Every
position outside the pool keeps v = y.

* ``soft_topk_gates``: on a CUDA tensor, the hand-written kernel in
  ``csrc/soft_topk.cu`` (one warp per row in registers; see the note
  there); on a CPU tensor, the plain version.  It computes in f32 and
  returns the input's dtype, like the Pallas wrapper.  It is forward only
  and raises on logits that require grad while grad is enabled.  Each
  kernel launch adds one to ``LAUNCHES["soft_topk_gates"]``.
* ``soft_topk_gates_plain``: the same steps in plain PyTorch on any
  device: a stable argsort, the pool grown by batched masked steps with
  the kernel's order of additions, the scatter back.  On the card its
  division by eps is, as in the kernel, a product with the f32 reciprocal
  of eps, so there the two agree to the last bit on the same f32 logits
  for every eps.  (The CPU divides: for an eps that is not a power of
  two, z and so the gates may differ there by an ulp.)

``repro_torch.kernels.ref.soft_topk_gates_ref`` (minimax closed form) is
the independent oracle.
"""

from __future__ import annotations

import ctypes

import torch
from torch.distributed.tensor import DTensor

from repro_torch.kernels import _build
from repro_torch.sharding import local as _local

# Launch count of the kernel; only the wrapper below increments it.
LAUNCHES = {"soft_topk_gates": 0}
MAX_EXPERTS = 128


def reset_launches() -> None:
  LAUNCHES["soft_topk_gates"] = 0


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


def pool_at_k(y: torch.Tensor, k: int) -> torch.Tensor:
  """Non-increasing isotonic fit of (T, E) rows y that are non-increasing
  on [0, k) and on [k, E): the merge of those two solved segments.  The
  pool grows in the kernel's order (left, then right, within a step);
  every other position keeps its y."""
  t, e = y.shape
  if k == 0 or k == e or t == 0:
    return y.clone()
  pl = torch.full((t,), k - 1, device=y.device)
  pr = torch.full((t,), k, device=y.device)
  pooled = y[:, k - 1] < y[:, k]
  psum = y[:, k - 1] + y[:, k]
  count = torch.full((t,), 2.0, dtype=y.dtype, device=y.device)
  live = pooled
  # Each live step absorbs a neighbour, so at most E - 2 steps are live.
  for _ in range(e - 2):
    if not bool(live.any()):
      break
    gamma = psum / count
    nl = torch.gather(y, 1, torch.clamp(pl - 1, min=0)[:, None])[:, 0]
    nr = torch.gather(y, 1, torch.clamp(pr + 1, max=e - 1)[:, None])[:, 0]
    absorb_l = live & (pl > 0) & (nl < gamma)
    absorb_r = live & (pr < e - 1) & (gamma < nr)
    psum = torch.where(absorb_l, psum + nl, psum)
    psum = torch.where(absorb_r, psum + nr, psum)
    count = count + absorb_l.to(y.dtype) + absorb_r.to(y.dtype)
    pl = pl - absorb_l.to(pl.dtype)
    pr = pr + absorb_r.to(pr.dtype)
    live = absorb_l | absorb_r
  pos = torch.arange(e, device=y.device)
  in_pool = pooled[:, None] & (pl[:, None] <= pos) & (pos <= pr[:, None])
  return torch.where(in_pool, (psum / count)[:, None], y)


def soft_topk_gates_plain(logits: torch.Tensor, k: int,
                          regularization_strength: float = 1.0
                          ) -> torch.Tensor:
  """Plain version: (T, E) -> (T, E) gates, on the input's device."""
  _check(logits, k)
  z = logits.to(torch.float32) / regularization_strength
  e = z.shape[1]
  w = (torch.arange(e, device=z.device) < k).to(z.dtype)
  sigma = torch.argsort(-z, dim=-1, stable=True)
  s = torch.gather(z, 1, sigma)
  v = pool_at_k(s - w, k)
  out = torch.empty_like(s).scatter_(1, sigma, s - v)
  return out.to(logits.dtype)


def soft_topk_gates(logits: torch.Tensor, k: int,
                    regularization_strength: float = 1.0) -> torch.Tensor:
  """Fused soft top-k gate mass for each row of ``logits`` (T, E).

  Gates in [0, 1]^E summing to k per row.  A CUDA tensor runs the kernel;
  a CPU tensor the plain version; any other device raises.  The gate is
  forward only, as in the reference: logits that require grad while grad
  is enabled raise (``core.soft_topk_mask`` is the differentiable route).
  """
  if torch.is_grad_enabled() and logits.requires_grad:
    raise RuntimeError(
        "soft_topk_gates is forward only and has no backward: under "
        "autograd use repro_torch.core.soft_topk_mask (the router does)")
  if isinstance(logits, DTensor):
    # Rows local, E whole: each rank gates its own tokens.
    return _local.on_rows(soft_topk_gates, logits, k,
                          regularization_strength)
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
      ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
  with _build.on_device(z.device):
    err = launch(z.data_ptr(), out.data_ptr(), rows, e, k,
                 float(regularization_strength),
                 _build.current_stream(z.device))
  if err != 0:
    raise RuntimeError(f"soft_topk_gates kernel launch failed with CUDA "
                       f"error {err}")
  LAUNCHES["soft_topk_gates"] += 1
  return out.to(logits.dtype)
