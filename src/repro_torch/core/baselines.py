"""The paper's comparison baselines, in PyTorch.

Counterpart of ``repro.core.baselines``:

- OT / Sinkhorn soft sort & rank (Cuturi et al., 2019): O(T m n) time,
  O(n^2) memory for m = n; differentiation unrolls the Sinkhorn iterates
  (autograd through a plain loop, as the reference differentiates its
  ``lax.scan``), so the backward keeps about one (..., n, n) tensor an
  iterate.
- All-pairs soft rank (Qin et al., 2010): O(n^2) sigmoid comparisons.

The reference computes both in XLA ops, not Pallas, so PyTorch ops are the
port here, on the card as on the CPU: there is no kernel to write.  Every
tensor follows theta's dtype and device (the reference's takes the default
float dtype, which is theta's in its tests: f32, f64 under x64).  Not
exported by ``repro_torch.core``, as the reference's ``repro.core`` does not
export them.  ``chip_smoke.py`` times them beside ``soft_rank`` (Figure 4,
right).
"""

from __future__ import annotations

import math

import torch


def allpairs_rank(theta: torch.Tensor,
                  temperature: float = 1.0) -> torch.Tensor:
  """r_i = 1 + sum_{j != i} sigmoid((theta_j - theta_i) / tau); descending
  ranks (rank 1 = largest)."""
  diff = theta[..., None, :] - theta[..., :, None]  # [.., i, j] = th_j - th_i
  pair = torch.sigmoid(diff / temperature)
  n = theta.shape[-1]
  eye = torch.eye(n, dtype=theta.dtype, device=theta.device)
  pair = pair * (1.0 - eye)
  return 1.0 + torch.sum(pair, dim=-1)


def _sinkhorn(log_k: torch.Tensor, num_iters: int) -> torch.Tensor:
  """Log-domain Sinkhorn onto uniform marginals; returns the log coupling."""
  n, m = log_k.shape[-2], log_k.shape[-1]
  like = dict(dtype=log_k.dtype, device=log_k.device)
  log_a = torch.full(log_k.shape[:-1], -math.log(n), **like)
  log_b = torch.full(log_k.shape[:-2] + (m,), -math.log(m), **like)
  f = torch.zeros(log_k.shape[:-1], **like)
  g = torch.zeros(log_k.shape[:-2] + (m,), **like)
  for _ in range(num_iters):
    f = log_a - torch.logsumexp(log_k + g[..., None, :], dim=-1)
    g = log_b - torch.logsumexp(log_k + f[..., None], dim=-2)
  return log_k + f[..., None] + g[..., None, :]


def ot_rank_and_sort(theta: torch.Tensor, epsilon: float = 1e-2,
                     num_iters: int = 100
                     ) -> tuple[torch.Tensor, torch.Tensor]:
  """OT soft rank & sort of Cuturi et al. (m = n, squared cost).

  Returns (soft_ranks, soft_sorted) with the descending-rank convention
  (rank 1 = largest), matching ``repro_torch.core.operators``.
  """
  n = theta.shape[-1]
  like = dict(dtype=theta.dtype, device=theta.device)
  rho = torch.arange(n, 0, -1, **like)
  # Squashed as in the reference implementation, to keep the cost
  # well-scaled.
  t = torch.sigmoid(theta)
  r = torch.sigmoid(rho / n)
  cost = 0.5 * (-t[..., :, None] + r) ** 2   # D(-theta, rho)
  p = torch.exp(_sinkhorn(-cost / epsilon, num_iters))  # ~doubly stoch. / n
  # Position j holds sorted-descending slot j, i.e. rank j + 1.
  ranks_by_pos = torch.arange(1, n + 1, **like)
  soft_ranks = n * torch.einsum("...ij,j->...i", p, ranks_by_pos)
  soft_sorted = n * torch.einsum("...ij,...i->...j", p, theta)
  return soft_ranks, soft_sorted


def ot_rank(theta: torch.Tensor, epsilon: float = 1e-2,
            num_iters: int = 100) -> torch.Tensor:
  return ot_rank_and_sort(theta, epsilon, num_iters)[0]


def ot_sort(theta: torch.Tensor, epsilon: float = 1e-2,
            num_iters: int = 100) -> torch.Tensor:
  return ot_rank_and_sort(theta, epsilon, num_iters)[1]
