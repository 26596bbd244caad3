"""The paper's projection, soft sort and soft top-k, in plain PyTorch.

A frozen yardstick for the benchmark's reference (Blondel et al., "Fast
Differentiable Sorting and Ranking", ICML 2020, Eq. 5 and Prop. 3):

  P(z, w) = z - v(s, w_sorted)[sigma^{-1}],  s = z sorted descending,

with v the non-increasing isotonic regression of s - w_sorted (the
quadratic regularisation).  The isotonic fit is the closed max-min form

  v_i = min_{j <= i} max_{l >= i} mean(y_j .. y_l),

computed over all (j, l) pairs in float64 (O(n^2) a row): no pool adjacent
violators loop, so it shares no algorithm with the program's PAV kernel.
Autograd differentiates it: the max and min pass the gradient to the one
mean that v_i equals, 1 / |block| on each member of its block, which is
the Jacobian of Lemma 2.  Nothing here imports the program.
"""

from __future__ import annotations

import torch


def isotonic_nonincreasing(y: torch.Tensor) -> torch.Tensor:
  """The non-increasing least-squares fit of each row of ``y`` (..., n),
  in float64, returned in ``y``'s dtype."""
  n = y.shape[-1]
  y64 = y.to(torch.float64)
  zero = torch.zeros(y64.shape[:-1] + (1,), dtype=torch.float64,
                     device=y.device)
  c = torch.cat([zero, torch.cumsum(y64, dim=-1)], dim=-1)     # (..., n+1)
  j = torch.arange(n, device=y.device)[:, None]
  l = torch.arange(n, device=y.device)[None, :]
  length = (l - j + 1).clamp(min=1).to(torch.float64)
  means = (c[..., None, 1:] - c[..., :-1, None]) / length      # [.., j, l]
  neg = torch.full((), float("-inf"), dtype=torch.float64, device=y.device)
  pos = torch.full((), float("inf"), dtype=torch.float64, device=y.device)
  means = torch.where(l >= j, means, neg)
  # best[j, i] = max over l >= i of means[j, l]
  best = torch.flip(torch.cummax(torch.flip(means, [-1]), dim=-1).values,
                    [-1])
  best = torch.where(l >= j, best, pos)           # only j <= i (i = l index)
  return torch.amin(best, dim=-2).to(y.dtype)


def project(z: torch.Tensor, w_sorted: torch.Tensor) -> torch.Tensor:
  """P(z, w) for rows z (..., n) and weights w sorted descending (n,)."""
  s, sigma = torch.sort(z, dim=-1, descending=True, stable=True)
  v = isotonic_nonincreasing(s - w_sorted)
  return z - torch.zeros_like(v).scatter(-1, sigma, v)


def soft_topk_mask(logits: torch.Tensor, k: int, eps: float) -> torch.Tensor:
  """The soft top-k indicator: logits / eps projected onto the
  permutahedron of (1^k, 0^(n-k)); each row in [0, 1]^n summing to k."""
  n = logits.shape[-1]
  w = torch.zeros(n, dtype=logits.dtype, device=logits.device)
  w[:k] = 1.0
  return project(logits / eps, w)


def soft_sort_descending(values: torch.Tensor, eps: float) -> torch.Tensor:
  """The soft sort s_eps(theta) = P(rho / eps, theta), rho = (n, ..., 1)."""
  n = values.shape[-1]
  rho = torch.arange(n, 0, -1, dtype=values.dtype, device=values.device)
  z = rho / eps
  w_sorted = torch.sort(values, dim=-1, descending=True, stable=True).values
  v = isotonic_nonincreasing(z - w_sorted)
  return z - v


def soft_trimmed_mean(losses: torch.Tensor, trim_fraction: float,
                      eps: float) -> torch.Tensor:
  """Soft least trimmed squares over one flat row of token losses (paper
  §6.4): the mean of the soft-sorted losses without the largest
  round(trim_fraction * n)."""
  flat = losses.reshape(-1)
  n = flat.shape[0]
  k = int(round(trim_fraction * n))
  if k == 0:
    return torch.mean(flat)
  s = soft_sort_descending(flat, eps)
  return torch.sum(s[k:]) / (n - k)
