"""Pure-torch oracles for the isotonic kernels.

Independent implementations (no shared code with ``repro_torch.core`` or
the kernels), used by tests as ground truth and registered as the
``"minimax"`` backend:

* ``pav_l2_ref`` / ``pav_kl_ref``: the minimax characterization of isotonic
  regression,  v_i = min_{j<=i} max_{k>=i} gamma(y[j..k]),  vectorized as an
  O(n^2) interval-aggregate matrix.  Exact (same minimizer as PAV).
* ``soft_topk_gates_ref``: the router gate (projection of logits/eps onto
  the k-subset permutahedron) composed from ``pav_l2_ref``; the oracle of
  the ``soft_topk_gates`` kernel.

Counterpart of ``repro.kernels.ref``.
"""

from __future__ import annotations

from typing import Callable

import torch

_NEG = -1e30


def _pairwise_scan(x: torch.Tensor,
                   op: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
                   ) -> torch.Tensor:
  """Inclusive scan along the last axis in log2(n) pairwise passes.

  Every output is combined along a binary tree of depth log2(n), like
  ``jax.lax.associative_scan``, so the rounding error grows with log(n)
  and not with n as in a sequential ``cumsum``.
  """
  n = x.shape[-1]
  shift = 1
  while shift < n:
    x = torch.cat([x[..., :shift], op(x[..., :-shift], x[..., shift:])],
                  dim=-1)
    shift *= 2
  return x


def _interval_masks(n: int, device: torch.device):
  j = torch.arange(n, device=device)[:, None]
  k = torch.arange(n, device=device)[None, :]
  return j, k, j <= k


def _minimax(gamma: torch.Tensor) -> torch.Tensor:
  """v_i = min_{j<=i} max_{k>=i} gamma[..., j, k] (valid for j <= k)."""
  n = gamma.shape[-1]
  _, _, upper = _interval_masks(n, gamma.device)
  g = torch.where(upper, gamma, torch.full_like(gamma, _NEG))
  # inner[..., j, i] = max_{k >= i} g[..., j, k]: reverse cummax over k.
  inner = torch.flip(torch.cummax(torch.flip(g, (-1,)), dim=-1).values,
                     (-1,))
  # v_i = min over j <= i of inner[..., j, i].
  masked = torch.where(upper, inner, torch.full_like(inner, -_NEG))
  return torch.amin(masked, dim=-2)


def pav_l2_ref(y: torch.Tensor) -> torch.Tensor:
  """Isotonic regression (non-increasing fit) via minimax. Last axis."""
  n = y.shape[-1]
  j, k, upper = _interval_masks(n, y.device)
  # sums[.., j, k] = sum(y[j..k]) via a masked pairwise scan along k, never
  # a difference of global cumsums: those grow to O(n * max|y|) while the
  # interval sums stay small, and the difference cancels.
  yk = y[..., None, :].expand(y.shape[:-1] + (n, n))
  g = torch.where(upper, yk, torch.zeros_like(yk))
  sums = _pairwise_scan(g, torch.add)
  length = torch.clamp(k - j + 1, min=1).to(y.dtype)
  return _minimax(sums / length)


def pav_kl_ref(s: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
  """Entropic isotonic optimization via minimax on LSE-difference gammas.

  The gammas are formed in f64 and the result is returned in the input's
  dtype.  In f32 a gamma, the difference of two log-sum-exps of the size
  of n / eps, carries an error of a few ulps of that size: near-tied
  intervals then give the positions of one block values an ulp apart, and
  the Lemma 2 backward, which reads blocks from runs of equal outputs,
  splits them (soft_rank's gradient at (256, 100), eps 0.1, off by 24%).
  In f64 a block's positions take the same value, which rounds to one f32.
  """
  n = s.shape[-1]
  _, _, upper = _interval_masks(n, s.device)
  wide = torch.promote_types(s.dtype, torch.float64)

  def interval_lse(x: torch.Tensor) -> torch.Tensor:
    # interval_lse[..., j, k] = LSE(x[j..k]) via a masked logaddexp scan
    # along k.  A cumsum-of-exp difference would cancel for intervals far
    # below the row max (the regime soft sort hits: x = rho/eps spans
    # n/eps); pairwise logaddexp is stable at any dynamic range.
    x = x.to(wide)
    xk = x[..., None, :].expand(x.shape[:-1] + (n, n))
    g = torch.where(upper, xk, torch.full_like(xk, _NEG))
    return _pairwise_scan(g, torch.logaddexp)

  return _minimax(interval_lse(s) - interval_lse(w)).to(s.dtype)


def soft_topk_gates_ref(logits: torch.Tensor, k: int,
                        regularization_strength: float = 1.0
                        ) -> torch.Tensor:
  """Oracle for the fused router kernel: projection of logits/eps onto the
  k-subset permutahedron, composed from ``pav_l2_ref``.  (T, E) -> (T, E)."""
  z = logits / regularization_strength
  n = z.shape[-1]
  w = torch.zeros((n,), dtype=z.dtype, device=z.device)
  w[:k] = 1
  sigma = torch.argsort(-z, dim=-1, stable=True)
  s = torch.gather(z, -1, sigma)
  v = pav_l2_ref(s - w)
  return z - torch.zeros_like(v).scatter(-1, sigma, v)
