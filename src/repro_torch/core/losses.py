"""Losses built on the soft operators (paper §6 applications).

Counterpart of ``repro.core.losses``, with the same signatures minus
``plan=``:

- soft Spearman's rank-correlation loss (label ranking, §6.3)
- soft top-k classification loss (§6.1)
- soft least-trimmed-squares (robust regression, §6.4), also used to trim
  outlier *token* losses at LM-pretraining scale.
"""

from __future__ import annotations

import torch

from repro_torch.core.operators import soft_rank, soft_sort
from repro_torch.core.permutations import SortContext

# ---------------------------------------------------------------------------
# Spearman (§6.3)
# ---------------------------------------------------------------------------


def soft_spearman_loss(theta: torch.Tensor, target_ranks: torch.Tensor,
                       regularization_strength: float = 1.0,
                       regularization: str = "l2",
                       direction: str = "ASCENDING",
                       sort_context: SortContext | None = None
                       ) -> torch.Tensor:
  """1/2 ||target_ranks - r_eps(theta)||^2, averaged over the batch.

  Minimizing it maximizes Spearman's rho (paper §6.3).  Callers ranking
  the same scores more than once per step should share one
  ``SortContext(theta)``.
  """
  r = soft_rank(theta, regularization_strength, regularization, direction,
                sort_context=sort_context)
  per_example = 0.5 * torch.sum((r - target_ranks) ** 2, dim=-1)
  return torch.mean(per_example)


def spearman_correlation(pred_ranks: torch.Tensor,
                         target_ranks: torch.Tensor) -> torch.Tensor:
  """Hard Spearman's rho between two rank vectors (metric, last axis)."""

  def _center(x):
    return x - torch.mean(x, dim=-1, keepdim=True)

  a, b = _center(pred_ranks), _center(target_ranks)
  num = torch.sum(a * b, dim=-1)
  den = torch.sqrt(torch.sum(a * a, dim=-1) * torch.sum(b * b, dim=-1))
  return num / torch.clamp(den, min=1e-12)


def hard_rank(theta: torch.Tensor,
              direction: str = "ASCENDING") -> torch.Tensor:
  """Ranks 1..n (ties broken by order), non-differentiable."""
  sgn = 1.0 if direction == "DESCENDING" else -1.0
  sigma = torch.argsort(-sgn * theta.detach(), dim=-1, stable=True)
  n = theta.shape[-1]
  vals = torch.arange(1, n + 1, dtype=theta.dtype,
                      device=theta.device).expand(theta.shape)
  return torch.zeros_like(theta).scatter(-1, sigma, vals)


# ---------------------------------------------------------------------------
# Top-k classification (§6.1)
# ---------------------------------------------------------------------------


def soft_topk_loss(theta: torch.Tensor, labels: torch.Tensor, k: int = 1,
                   regularization_strength: float = 1.0,
                   regularization: str = "l2",
                   squash: bool = True) -> torch.Tensor:
  """Loss encouraging the true label to appear in the soft top-k.

  Scores are squashed to [0, 1] by a logistic map, soft-ranked
  (descending, rank 1 = best), and the loss penalizes the true label's
  soft rank exceeding k (paper §6.1, after Cuturi et al. 2019).
  """
  if squash:
    theta = torch.sigmoid(theta)
  r = soft_rank(theta, regularization_strength, regularization,
                direction="DESCENDING")
  r_true = torch.gather(r, -1, labels[..., None].long())[..., 0]
  return torch.mean(torch.relu(r_true - k))


def topk_accuracy(theta: torch.Tensor, labels: torch.Tensor,
                  k: int = 1) -> torch.Tensor:
  top = torch.argsort(-theta.detach(), dim=-1, stable=True)[..., :k]
  return torch.mean(torch.any(top == labels[..., None], dim=-1).float())


# ---------------------------------------------------------------------------
# Soft least trimmed squares (§6.4)
# ---------------------------------------------------------------------------


def soft_lts_loss(losses: torch.Tensor, trim_count: int,
                  regularization_strength: float = 1.0,
                  regularization: str = "l2",
                  sort_context: SortContext | None = None) -> torch.Tensor:
  """Mean of the soft-sorted losses with the largest ``trim_count`` dropped.

  (paper Eq. 10): losses are soft-sorted descending and entries k+1..n
  are averaged.  eps -> 0 recovers hard least trimmed squares; eps -> inf
  recovers plain least squares.
  """
  n = losses.shape[-1]
  s = soft_sort(losses, regularization_strength, regularization,
                direction="DESCENDING", sort_context=sort_context)
  return torch.sum(s[..., trim_count:], dim=-1) / (n - trim_count)


def soft_trimmed_token_loss(token_losses: torch.Tensor, trim_fraction: float,
                            regularization_strength: float = 1.0,
                            regularization: str = "l2") -> torch.Tensor:
  """Soft-LTS applied to a flat vector of per-token LM losses.

  The framework-scale use of §6.4: the whole batch is flattened into one
  row (batch*seq ~ 1e6 tokens per step), where only an O(n log n)
  operator is viable.
  """
  flat = token_losses.reshape(-1)
  k = int(round(trim_fraction * flat.shape[0]))
  if k == 0:
    return torch.mean(flat)
  return torch.mean(soft_lts_loss(flat, k, regularization_strength,
                                  regularization))
