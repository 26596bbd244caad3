"""Soft sorting and ranking operators (paper Eq. 5-6) and derived top-k.

Counterpart of ``repro.core.operators``, with the same signatures minus
``plan=``.  Conventions follow the paper: the *descending* direction is
primitive; ``rho = (n, n-1, ..., 1)``; rank 1 is assigned to the largest
entry under the descending direction.  All operators act on the last axis,
accept arbitrary leading batch dimensions, and create their constants on
the input's device.
"""

from __future__ import annotations

import torch

from repro_torch.core.permutations import SortContext
from repro_torch.core.projection import projection_permutahedron

_DIRECTIONS = ("ASCENDING", "DESCENDING")


def _rho(n: int, like: torch.Tensor) -> torch.Tensor:
  return torch.arange(n, 0, -1, dtype=like.dtype, device=like.device)


def _ctx_perm(sort_context: SortContext | None, descending: bool):
  """(sigma, sigma^{-1}) of the context's values in the given direction.

  Tie order may differ from a fresh argsort of the transformed argument
  (operators negate or scale their input before projecting), which is
  harmless: equal values merge into one isotonic block either way.
  """
  if sort_context is None:
    return None
  _, sigma, sigma_inv = (sort_context.descending() if descending
                         else sort_context.ascending())
  return sigma, sigma_inv


def _check_direction(direction: str) -> bool:
  if direction not in _DIRECTIONS:
    raise ValueError(f"direction must be one of {_DIRECTIONS}")
  return direction == "DESCENDING"


def soft_sort(values: torch.Tensor, regularization_strength: float = 1.0,
              regularization: str = "l2", direction: str = "DESCENDING",
              impl: str | None = None,
              sort_context: SortContext | None = None) -> torch.Tensor:
  """Soft sort: s_{eps*Psi}(theta) = P_Psi(rho/eps, theta) (paper Eq. 5).

  Parameters
  ----------
  values : Tensor, shape (..., n)
      Input scores (last axis; arbitrary leading batch dimensions).
  regularization_strength : float
      eps > 0.  As eps -> 0 the output approaches the hard sort (exactly
      hard for eps <= eps_min, Lemma 3).
  regularization : {"l2", "kl"}
      Psi: quadratic Q or entropic E.
  direction : {"DESCENDING", "ASCENDING"}
      "ASCENDING" is -soft_sort(-values).
  impl : {"auto", "cuda", "stack", "scan", "minimax"} or None
      Isotonic backend (``repro_torch.kernels.dispatch``).
  sort_context : SortContext or None
      A ``SortContext`` built on ``values``; supplies the argsort.

  Returns
  -------
  Tensor, shape (..., n)

  Notes
  -----
  O(n log n) per row: one descending sort plus a linear-time PAV solve.
  The projection's z argument (rho/eps) is descending by construction, so
  the fused pipeline skips that sort (``z_is_sorted``).
  """
  descending = _check_direction(direction)
  eps = regularization_strength
  n = values.shape[-1]
  # ASCENDING is -P(rho/eps, -theta): same sorted z, negated weights.
  w = values if descending else -values
  z = (_rho(n, values) / eps).expand(values.shape)
  out = projection_permutahedron(
      z, w, regularization, impl, z_is_sorted=True,
      w_perm=_ctx_perm(sort_context, descending=descending))
  return out if descending else -out


def soft_rank(values: torch.Tensor, regularization_strength: float = 1.0,
              regularization: str = "l2", direction: str = "DESCENDING",
              impl: str | None = None,
              sort_context: SortContext | None = None) -> torch.Tensor:
  """Soft rank: r_{eps*Psi}(theta) = P_Psi(-theta/eps, rho) (paper Eq. 6).

  Parameters
  ----------
  values : Tensor, shape (..., n)
      Input scores (last axis; arbitrary leading batch dimensions).
  regularization_strength : float
      eps > 0; eps -> 0 recovers the hard ranks exactly (Lemma 3).
  regularization : {"l2", "kl"}
      Psi: quadratic Q or entropic E.
  direction : {"DESCENDING", "ASCENDING"}
      "DESCENDING": rank 1 for the largest value; "ASCENDING": rank 1 for
      the smallest.
  impl : {"auto", "cuda", "stack", "scan", "minimax"} or None
      Isotonic backend.
  sort_context : SortContext or None
      A ``SortContext`` built on ``values``; supplies the argsort.

  Returns
  -------
  Tensor, shape (..., n)
      Soft ranks in [1, n]; differentiable everywhere in theta.
  """
  descending = _check_direction(direction)
  eps = regularization_strength
  # DESCENDING projects -theta/eps; ASCENDING projects +theta/eps.  Sorting
  # z descending is sorting theta ascending (resp. descending).
  z = (-values if descending else values) / eps
  return projection_permutahedron(
      z, _rho(values.shape[-1], values), regularization, impl,
      w_is_sorted=True,
      z_perm=_ctx_perm(sort_context, descending=not descending))


def soft_rank_kl_direct(values: torch.Tensor,
                        regularization_strength: float = 1.0,
                        direction: str = "DESCENDING",
                        impl: str | None = None,
                        sort_context: SortContext | None = None
                        ) -> torch.Tensor:
  """Appendix variant r~_E: KL projection directly onto P(rho).

  r~_{eps E}(theta) = exp(P_E(-theta/eps, log rho)).  Strictly positive
  soft ranks; same cost as ``soft_rank``.  The weight log(rho) is
  descending by construction, so the fused pipeline never sorts it.
  """
  descending = _check_direction(direction)
  eps = regularization_strength
  z = (-values if descending else values) / eps
  w = torch.log(_rho(values.shape[-1], values))
  return torch.exp(projection_permutahedron(
      z, w, "kl", impl, w_is_sorted=True,
      z_perm=_ctx_perm(sort_context, descending=not descending)))


def soft_topk_mask(values: torch.Tensor, k: int,
                   regularization_strength: float = 1.0,
                   regularization: str = "l2", impl: str | None = None,
                   sort_context: SortContext | None = None) -> torch.Tensor:
  """Differentiable top-k indicator in [0, 1]^n summing to k.

  Projection of theta/eps onto P(w) with w = (1,...,1,0,...,0) (k ones):
  the vertices of that permutahedron are the 0/1 indicators of k-subsets.

  Returns
  -------
  Tensor, shape (..., n)
      Mask in [0, 1]^n with sum k.
  """
  eps = regularization_strength
  n = values.shape[-1]
  # The k-ones mask is descending by construction: never sorted.
  w = torch.zeros((n,), dtype=values.dtype, device=values.device)
  w[:k] = 1
  return projection_permutahedron(
      values / eps, w, regularization, impl, w_is_sorted=True,
      z_perm=_ctx_perm(sort_context, descending=True))


def soft_quantile(values: torch.Tensor, q: float,
                  regularization_strength: float = 0.1,
                  regularization: str = "l2", impl: str | None = None,
                  sort_context: SortContext | None = None) -> torch.Tensor:
  """Differentiable q-quantile via the ascending soft sort.

  Returns element round(q * (n - 1)) of the ascending soft sort, one
  scalar per row (q = 0.5 is a soft median).
  """
  n = values.shape[-1]
  s = soft_sort(values, regularization_strength, regularization,
                direction="ASCENDING", impl=impl, sort_context=sort_context)
  idx = min(max(round(q * (n - 1)), 0), n - 1)
  return s[..., idx]


# ---------------------------------------------------------------------------
# Exact-regime thresholds (paper Lemma 3).
# ---------------------------------------------------------------------------


def eps_min(s: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
  """Largest eps at which P_Psi(z/eps, w) equals the hard operator.

  ``s`` and ``w`` are sorted descending, shape (..., n).  Returns
  min_i (s_i - s_{i+1}) / (w_i - w_{i+1}) per row; for eps <= eps_min the
  soft operator is exactly the hard one (Lemma 3).  O(n) per row.
  """
  ds = s[..., :-1] - s[..., 1:]
  dw = w[..., :-1] - w[..., 1:]
  return torch.amin(ds / dw, dim=-1)


def eps_max(s: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
  """Smallest eps beyond which the solution is the closed-form constant.

  max_{i<j} (s_i - s_j) / (w_i - w_j) per row, for ``s`` and ``w`` sorted
  descending.  O(n^2) per row: a diagnostic, not a production path.
  """
  n = s.shape[-1]
  i, j = torch.triu_indices(n, n, offset=1, device=s.device)
  return torch.amax((s[..., i] - s[..., j]) / (w[..., i] - w[..., j]),
                    dim=-1)
