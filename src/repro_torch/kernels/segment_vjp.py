"""Backward passes for the isotonic and projection VJPs (paper Lemma 2).

Counterpart of ``repro.kernels.segment_vjp``, in its ``"scatter"``
formulation.  The Jacobian of an isotonic solve is block-diagonal with
rank-1 blocks recovered from runs of equal values in the forward output, so
every VJP is a composition of three within-block primitives over a
(rows, n) batch: sum-broadcast, mean-broadcast and softmax.  Per-row block
ids are offset into one global id space and reduced with ``scatter_add_``
and ``scatter_reduce_(..., "amax")``, which are exact up to the order of
the additions.  Block sums are never taken as differences of cumulative
sums, which cancel at n = 2**20.
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
  """Per-position block start/end indices from the start mask; (B, n) each.

  Ported with the block recovery; only the reference's ``segscan``
  backward reads them, and the port has no ``segscan`` yet.
  """
  b, n = starts.shape
  iota = torch.arange(n, device=starts.device).expand(b, n)
  start_idx = torch.cummax(torch.where(starts, iota, 0), dim=1).values
  ends = torch.cat([starts[:, 1:], torch.ones_like(starts[:, :1])], dim=-1)
  end_idx = torch.flip(torch.cummin(
      torch.flip(torch.where(ends, iota, n - 1), (-1,)), dim=1).values, (-1,))
  return start_idx, end_idx


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


def isotonic_l2_bwd_scatter(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
  """Lemma 2 (Q): dv/dy has blocks 11^T/|B| -> within-block mean of g."""
  return scatter_mean_bcast(g, block_ids(v))


def isotonic_kl_bwd_scatter(s: torch.Tensor, w: torch.Tensor, v: torch.Tensor,
                            g: torch.Tensor):
  """Lemma 2 (E): grad_s = softmax(s_B) * sum(g_B) and
  grad_w = -softmax(w_B) * sum(g_B)."""
  bid = block_ids(v)
  gs = scatter_sum_bcast(g, bid)
  return scatter_softmax(s, bid) * gs, -scatter_softmax(w, bid) * gs


# Projection backward passes (fused whole-pipeline VJP): the same algebra,
# consuming the block starts the fused forward saved as a residual.  The
# reference's versions also take start/end indices, which only its
# ``segscan`` formulation reads; the port has no ``segscan`` yet.


def projection_l2_bwd_scatter(g: torch.Tensor,
                              starts: torch.Tensor) -> torch.Tensor:
  return scatter_mean_bcast(g, _ids_from_starts(starts))


def projection_kl_bwd_scatter(s: torch.Tensor, w: torch.Tensor,
                              g: torch.Tensor, starts: torch.Tensor):
  bid = _ids_from_starts(starts)
  gs = scatter_sum_bcast(g, bid)
  return scatter_softmax(s, bid) * gs, -scatter_softmax(w, bid) * gs
