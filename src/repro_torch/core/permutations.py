"""Sorting helpers for the projection pipeline.

Counterpart of ``repro.core.permutations``.  Permutations are computed on
detached values and applied with ``gather`` (int64 indices), which is
sort's own a.e. Jacobian: the permutation applied to the cotangent.

``torch.sort(..., descending=True, stable=True)`` orders ties by original
index, as ``jnp.argsort(-x, stable=True)`` does in the reference.  The
reference's packed single-key integer sorts are a workaround for XLA:CPU
and have no counterpart here.
"""

from __future__ import annotations

import torch


def argsort_descending(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
  """Non-differentiable descending argsort (stable, int64)."""
  return torch.sort(x.detach(), dim=dim, descending=True, stable=True).indices


def argsort_ascending(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
  """Non-differentiable ascending argsort (stable, int64)."""
  return torch.sort(x.detach(), dim=dim, stable=True).indices


def sort_descending(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
  """Differentiable descending sort along the last axis.

  Returns (sorted values, permutation sigma); the gradient flows through
  the gather.
  """
  sigma = argsort_descending(x)
  return torch.gather(x, -1, sigma), sigma


def inverse_permutation(sigma: torch.Tensor) -> torch.Tensor:
  """sigma^{-1} along the last axis (int64)."""
  iota = torch.arange(sigma.shape[-1], device=sigma.device).expand(sigma.shape)
  return torch.empty_like(sigma).scatter_(-1, sigma, iota)


def apply_inverse_permutation(v: torch.Tensor,
                              sigma: torch.Tensor) -> torch.Tensor:
  """Compute v_{sigma^{-1}} (paper notation) differentiably.

  out[sigma_k] = v_k: a scatter whose transpose is the matching gather.
  """
  return torch.zeros_like(v).scatter(-1, sigma, v)


class SortContext:
  """Caches the argsort of one tensor so several operators share one sort.

  Build it once on the raw values and pass it to every soft operator that
  sees the *same* tensor (``soft_rank`` twice in a Spearman loss, the
  ``soft_sort`` / ``soft_quantile`` pair, an eps sweep over identical
  scores): each direction's (sorted values, sigma, sigma^{-1}) triple is
  computed on first use and served from the cache afterwards.
  """

  def __init__(self, values: torch.Tensor):
    self.values = values.detach()
    self._cache: dict[bool, tuple[torch.Tensor, ...]] = {}

  def _get(self, descending: bool) -> tuple[torch.Tensor, ...]:
    if descending not in self._cache:
      x = self.values if descending else -self.values
      s, sigma = sort_descending(x)
      self._cache[descending] = (s if descending else -s, sigma,
                                 inverse_permutation(sigma))
    return self._cache[descending]

  def descending(self) -> tuple[torch.Tensor, ...]:
    """(values sorted descending, sigma, sigma^{-1}), all detached."""
    return self._get(True)

  def ascending(self) -> tuple[torch.Tensor, ...]:
    """(values sorted ascending, sigma, sigma^{-1}), all detached."""
    return self._get(False)
