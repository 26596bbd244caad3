"""Log-depth divide-and-conquer PAV: the ``"scan"`` isotonic backend.

Counterpart of ``repro.kernels.pav_scan``, in plain PyTorch on any device.
Level ``l`` starts from solved segments of size ``m = 2**l`` and merges
adjacent pairs into solved segments of size ``2m``: two isotonic
(non-increasing) solutions concatenate into one that may violate only at
the pair boundary, and the merged optimum differs from the concatenation
by exactly one pooled block spanning that boundary.  The pool starts as the
two boundary blocks (when they violate) and absorbs its left and right
neighbour blocks while they violate against it, all rows and pairs of a
level at once.  The reference's rules are kept:

* violations are strict (``<``), so ties never pool;
* left and right absorption of one step are decided against the same pool
  value (absorbing the left block only lowers it, and vice versa);
* rows are padded to a power of two with per-row sentinel blocks whose
  value is strictly below any real block value (l2: the row minimum; kl:
  ``min(s) - max(w) - log(n) - 1``, the mediant bound), so padding never
  pools with real data.

Both regularizations share the machinery through an aggregate algebra:
l2 registers ``(sum, count)`` merged by addition, value ``sum / count``;
kl registers ``(LSE s, LSE w)`` merged by ``logaddexp``, value their
difference.  Sums are only ever combined, never differenced.

The merge order differs from the stack machine's, so l2 values differ from
``pav_l2_stack`` in the last bits.  ``csrc/pav_scan.cu`` is this
algorithm as a CUDA kernel for both algebras, held against ``pav_l2_scan``
and ``pav_kl_scan``.
"""

from __future__ import annotations

from typing import Callable

import torch


def _next_pow2(n: int) -> int:
  return 1 if n <= 1 else 1 << (n - 1).bit_length()


def _gather(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
  """arr (B, N), idx (B, P) or (P,) -> (B, P) along the last axis."""
  if idx.dim() == 1:
    idx = idx.expand(arr.shape[0], idx.shape[0])
  return torch.gather(arr, 1, idx)


def _merge_level(start, end, regs, lvl, merge, block_value):
  """Merge adjacent solved segments of size 2**lvl, over all rows and all
  pairs of the level.  start/end/regs are (B, N); pair-indexed values are
  (B, N >> (lvl + 1)).  A block's registers live at its start position."""
  n = start.shape[1]
  m = 1 << lvl
  dev = start.device
  pairs = torch.arange(n >> (lvl + 1), device=dev)
  seg_lo = 2 * m * pairs          # first position of the pair
  seg_hi = seg_lo + 2 * m - 1     # last position of the pair
  bnd = seg_lo + m                # first position of the right segment

  l_start = _gather(start, bnd - 1)
  l_regs = tuple(_gather(r, l_start) for r in regs)
  r_regs = tuple(_gather(r, bnd) for r in regs)
  viol = block_value(l_regs) < block_value(r_regs)

  bnd_b = bnd.expand_as(l_start)
  pl = torch.where(viol, l_start, bnd_b)
  pr = torch.where(viol, _gather(end, bnd), bnd_b)
  pregs = tuple(torch.where(viol, a, b)
                for a, b in zip(merge(l_regs, r_regs), r_regs))

  live = viol
  while bool(live.any()):
    gamma = block_value(pregs)
    has_l = live & (pl > seg_lo)
    nb_l_start = _gather(start, torch.clamp(pl - 1, min=0))
    nb_l_regs = tuple(_gather(r, nb_l_start) for r in regs)
    absorb_l = has_l & (block_value(nb_l_regs) < gamma)
    has_r = live & (pr < seg_hi)
    nb_r_idx = torch.clamp(pr + 1, max=n - 1)
    nb_r_regs = tuple(_gather(r, nb_r_idx) for r in regs)
    nb_r_end = _gather(end, nb_r_idx)
    absorb_r = has_r & (gamma < block_value(nb_r_regs))
    pregs = tuple(torch.where(absorb_l, a, b)
                  for a, b in zip(merge(pregs, nb_l_regs), pregs))
    pl = torch.where(absorb_l, nb_l_start, pl)
    pregs = tuple(torch.where(absorb_r, a, b)
                  for a, b in zip(merge(pregs, nb_r_regs), pregs))
    pr = torch.where(absorb_r, nb_r_end, pr)
    live = absorb_l | absorb_r

  # Write the pools back into the per-position block structure.
  iota = torch.arange(n, device=dev)
  pair_of = iota >> (lvl + 1)
  ppl, ppr = pl[:, pair_of], pr[:, pair_of]
  in_pool = viol[:, pair_of] & (ppl <= iota) & (iota <= ppr)
  start = torch.where(in_pool, ppl, start)
  end = torch.where(in_pool, ppr, end)
  regs = tuple(torch.where(in_pool & (iota == ppl), p[:, pair_of], r)
               for p, r in zip(pregs, regs))
  return start, end, regs


def _dac_pav(regs0: tuple[torch.Tensor, ...],
             merge: Callable[[tuple, tuple], tuple],
             block_value: Callable[[tuple], torch.Tensor]) -> torch.Tensor:
  """Divide-and-conquer PAV on (B, N) singleton registers, N a power of
  two; returns the (B, N) fitted values, one float per block."""
  b_rows, n = regs0[0].shape
  start = torch.arange(n, device=regs0[0].device).expand(b_rows, n)
  end = start
  regs = regs0
  for lvl in range(n.bit_length() - 1):
    start, end, regs = _merge_level(start, end, regs, lvl, merge,
                                    block_value)
  return block_value(tuple(_gather(r, start) for r in regs))


def _pad_cols(x: torch.Tensor, n_pad: int, fill: torch.Tensor):
  """Append ``n_pad`` columns of the per-row ``fill`` (shape (B, 1))."""
  if n_pad == 0:
    return x
  return torch.cat([x, fill.expand(x.shape[0], n_pad)], dim=1)


def pav_l2_scan(y: torch.Tensor) -> torch.Tensor:
  """Batched isotonic regression (non-increasing) on (B, n): D&C PAV."""
  dt = torch.promote_types(y.dtype, torch.float32)
  yc = y.to(dt)
  b, n = yc.shape
  if n <= 1 or b == 0:
    return yc.to(y.dtype)
  # Sentinel: the row minimum never strictly violates against a real
  # block (block means are >= the row minimum; comparisons are strict).
  yp = _pad_cols(yc, _next_pow2(n) - n, yc.amin(dim=1, keepdim=True))
  out = _dac_pav((yp, torch.ones_like(yp)),
                 merge=lambda a, c: (a[0] + c[0], a[1] + c[1]),
                 block_value=lambda r: r[0] / torch.clamp(r[1], min=1e-30))
  return out[:, :n].to(y.dtype)


def pav_kl_scan(s: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
  """Batched entropic isotonic optimization on (B, n) x (B, n): D&C PAV."""
  dt = torch.promote_types(s.dtype, torch.float32)
  sc, wc = s.to(dt), w.to(dt)
  b, n = sc.shape
  if n <= 1 or b == 0:
    # Singleton blocks: gamma_E({i}) = s_i - w_i (Eq. 8).
    return (sc - wc).to(s.dtype)
  n_pad = _next_pow2(n) - n
  # Sentinel value min(s) - max(w) - log(n) - 1 is strictly below any real
  # block value (LSE(s_B) >= min(s), LSE(w_B) <= max(w) + log n) and, by
  # the mediant inequality, below any pool of real blocks too.
  s_pad = sc.amin(dim=1, keepdim=True)
  log_n = torch.log(torch.tensor(float(n), dtype=dt, device=sc.device))
  w_pad = wc.amax(dim=1, keepdim=True) + log_n + 1
  out = _dac_pav((_pad_cols(sc, n_pad, s_pad), _pad_cols(wc, n_pad, w_pad)),
                 merge=lambda a, c: (torch.logaddexp(a[0], c[0]),
                                     torch.logaddexp(a[1], c[1])),
                 block_value=lambda r: r[0] - r[1])
  return out[:, :n].to(s.dtype)
