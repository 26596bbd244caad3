"""Backward passes for the isotonic and projection VJPs (paper Lemma 2).

Counterpart of ``repro.kernels.segment_vjp``.  The Jacobian of an isotonic
solve is block-diagonal with rank-1 blocks recovered from runs of equal
values in the forward output, so every VJP is a composition of three
within-block primitives over a (rows, n) batch: sum-broadcast,
mean-broadcast and softmax.  Two interchangeable formulations are
registered in the backward table of ``repro_torch.kernels.dispatch``:

* ``"segscan"``: blocks are contiguous runs, so each within-block
  reduction is a segmented inclusive scan (a Hillis-Steele doubling in
  log2(n) passes of tensor ops, carrying a reset flag at block starts)
  read at the block's end position.  No scatter; the reference's default.
* ``"scatter"``: per-row block ids are offset into one global id space and
  reduced with ``scatter_add_`` and ``scatter_reduce_(..., "amax")``.

Both are exact up to the order of the additions.  Block sums are never
taken as differences of cumulative sums, which cancel at soft-sort dynamic
ranges and at n = 2**20.
"""

from __future__ import annotations

import torch

# ---------------------------------------------------------------------------
# Block-structure recovery.
# ---------------------------------------------------------------------------


def block_starts(v: torch.Tensor) -> torch.Tensor:
  """Boolean (B, n) marking the first position of each run of equal values."""
  first = torch.ones_like(v[:, :1], dtype=torch.bool)
  return torch.cat([first, v[:, 1:] != v[:, :-1]], dim=-1)


def block_ids(v: torch.Tensor) -> torch.Tensor:
  """Per-row segment ids from runs of equal values, v: (B, n) -> (B, n)."""
  return _ids_from_starts(block_starts(v))


def _ids_from_starts(starts: torch.Tensor) -> torch.Tensor:
  return torch.cumsum(starts.to(torch.int64), dim=-1) - 1


def start_end_indices(
    starts: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
  """Per-position block start/end indices from the start mask; (B, n) each."""
  b, n = starts.shape
  iota = torch.arange(n, device=starts.device).expand(b, n)
  start_idx = torch.cummax(torch.where(starts, iota, 0), dim=1).values
  ends = torch.cat([starts[:, 1:], torch.ones_like(starts[:, :1])], dim=-1)
  end_idx = torch.flip(torch.cummin(
      torch.flip(torch.where(ends, iota, n - 1), (-1,)), dim=1).values, (-1,))
  return start_idx, end_idx


# ---------------------------------------------------------------------------
# "segscan" primitives: segmented prefix scans + block-end gathers.
# ---------------------------------------------------------------------------


def _seg_scan(x: torch.Tensor, starts: torch.Tensor, combine) -> torch.Tensor:
  """Inclusive segmented scan along the last axis, resetting at starts.

  Hillis-Steele doubling over the associative pair (value, flag):
  (va, fa) . (vb, fb) = (vb if fb else combine(va, vb), fa | fb).  Pass
  ``k`` combines every position with the one 2**k to its left, so each
  output is a tree of depth log2(n) over its block's prefix, never a
  difference of sums.
  """
  n = x.shape[-1]
  v, f = x, starts
  shift = 1
  while shift < n:
    vr, fr = v[..., shift:], f[..., shift:]
    v = torch.cat([v[..., :shift],
                   torch.where(fr, vr, combine(v[..., :-shift], vr))], dim=-1)
    f = torch.cat([f[..., :shift], fr | f[..., :-shift]], dim=-1)
    shift *= 2
  return v


def _seg_total(x: torch.Tensor, starts: torch.Tensor, end_idx: torch.Tensor,
               combine) -> torch.Tensor:
  """Within-block reduction broadcast to every position of the block."""
  return torch.gather(_seg_scan(x, starts, combine), -1, end_idx)


def seg_sum_bcast(g: torch.Tensor, starts: torch.Tensor,
                  end_idx: torch.Tensor) -> torch.Tensor:
  return _seg_total(g, starts, end_idx, torch.add)


def seg_mean_bcast(g: torch.Tensor, starts: torch.Tensor,
                   start_idx: torch.Tensor,
                   end_idx: torch.Tensor) -> torch.Tensor:
  cnt = (end_idx - start_idx + 1).to(g.dtype)
  return seg_sum_bcast(g, starts, end_idx) / cnt


def seg_softmax(x: torch.Tensor, starts: torch.Tensor,
                end_idx: torch.Tensor) -> torch.Tensor:
  """Softmax within each contiguous block (max-shifted, exact, stable)."""
  m = _seg_total(x, starts, end_idx, torch.maximum)
  ex = torch.exp(x - m)
  return ex / _seg_total(ex, starts, end_idx, torch.add)


# ---------------------------------------------------------------------------
# Scatter primitives: globally offset segment ids.
# ---------------------------------------------------------------------------


def _flat_ids(bid: torch.Tensor) -> torch.Tensor:
  """Offset per-row block ids into one global id space (rows never mix)."""
  b, n = bid.shape
  offsets = torch.arange(b, device=bid.device)[:, None] * n
  return (bid + offsets).reshape(-1)


def _segment_sum(x: torch.Tensor, gid: torch.Tensor) -> torch.Tensor:
  return torch.zeros_like(x).scatter_add_(0, gid, x)


def scatter_sum_bcast(g: torch.Tensor, bid: torch.Tensor) -> torch.Tensor:
  """Within-block sum broadcast back to positions; g, bid: (B, n)."""
  gid = _flat_ids(bid)
  return _segment_sum(g.reshape(-1), gid)[gid].reshape(g.shape)


def scatter_mean_bcast(g: torch.Tensor, bid: torch.Tensor) -> torch.Tensor:
  gid = _flat_ids(bid)
  flat = g.reshape(-1)
  gsum = _segment_sum(flat, gid)
  cnt = _segment_sum(torch.ones_like(flat), gid)
  return (gsum / torch.clamp(cnt, min=1))[gid].reshape(g.shape)


def scatter_softmax(x: torch.Tensor, bid: torch.Tensor) -> torch.Tensor:
  """Softmax within each block (exact, stable); x, bid: (B, n)."""
  gid = _flat_ids(bid)
  flat = x.reshape(-1)
  smax = torch.full_like(flat, float("-inf")).scatter_reduce_(
      0, gid, flat, "amax")
  ex = torch.exp(flat - smax[gid])
  return (ex / _segment_sum(ex, gid)[gid]).reshape(x.shape)


# ---------------------------------------------------------------------------
# Registered backward passes.  Contract: flattened (rows, n) arrays in,
# gradient arrays of the same shape out (dispatch restores batch shapes).
# ---------------------------------------------------------------------------


def isotonic_l2_bwd_segscan(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
  """Lemma 2 (Q): dv/dy has blocks 11^T/|B| -> within-block mean of g."""
  starts = block_starts(v)
  start_idx, end_idx = start_end_indices(starts)
  return seg_mean_bcast(g, starts, start_idx, end_idx)


def isotonic_l2_bwd_scatter(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
  """Lemma 2 (Q): dv/dy has blocks 11^T/|B| -> within-block mean of g."""
  return scatter_mean_bcast(g, block_ids(v))


def isotonic_kl_bwd_segscan(s: torch.Tensor, w: torch.Tensor,
                            v: torch.Tensor, g: torch.Tensor):
  """Lemma 2 (E): grad_s = softmax(s_B) * sum(g_B) and
  grad_w = -softmax(w_B) * sum(g_B)."""
  starts = block_starts(v)
  _, end_idx = start_end_indices(starts)
  gs = seg_sum_bcast(g, starts, end_idx)
  return (seg_softmax(s, starts, end_idx) * gs,
          -seg_softmax(w, starts, end_idx) * gs)


def isotonic_kl_bwd_scatter(s: torch.Tensor, w: torch.Tensor, v: torch.Tensor,
                            g: torch.Tensor):
  """Lemma 2 (E): grad_s = softmax(s_B) * sum(g_B) and
  grad_w = -softmax(w_B) * sum(g_B)."""
  bid = block_ids(v)
  gs = scatter_sum_bcast(g, bid)
  return scatter_softmax(s, bid) * gs, -scatter_softmax(w, bid) * gs


# Projection backward passes (fused whole-pipeline VJP): the same algebra,
# consuming the block starts that the fused forward saved as a residual
# (``segscan`` derives each position's block start/end indices from them).


def projection_l2_bwd_segscan(g: torch.Tensor,
                              starts: torch.Tensor) -> torch.Tensor:
  """Lemma 2 (Q) with precomputed blocks: within-block mean of g."""
  start_idx, end_idx = start_end_indices(starts)
  return seg_mean_bcast(g, starts, start_idx, end_idx)


def projection_l2_bwd_scatter(g: torch.Tensor,
                              starts: torch.Tensor) -> torch.Tensor:
  return scatter_mean_bcast(g, _ids_from_starts(starts))


def projection_kl_bwd_segscan(s: torch.Tensor, w: torch.Tensor,
                              g: torch.Tensor, starts: torch.Tensor):
  """Lemma 2 (E) with precomputed blocks: softmax-weighted block sums."""
  _, end_idx = start_end_indices(starts)
  gs = seg_sum_bcast(g, starts, end_idx)
  return (seg_softmax(s, starts, end_idx) * gs,
          -seg_softmax(w, starts, end_idx) * gs)


def projection_kl_bwd_scatter(s: torch.Tensor, w: torch.Tensor,
                              g: torch.Tensor, starts: torch.Tensor):
  bid = _ids_from_starts(starts)
  gs = scatter_sum_bcast(g, bid)
  return scatter_softmax(s, bid) * gs, -scatter_softmax(w, bid) * gs
