"""Padded batched op family with *exact* (bitwise) padding semantics.

Counterpart of ``repro.serving.ops``.  The batcher pads every request up to
its shape bucket.  Naive padding (zeros, repeats of the last element)
changes the isotonic problem: pads can pool with real entries and perturb
every output lane.  Pads are built so that, per row with true length ``n``
inside a bucket of width ``N``:

1. **Pads sort strictly below every real entry**, so after the descending
   sort the real entries occupy positions ``0..n-1`` in the order of the
   unpadded call, and the prefix arithmetic of every backend (the stack
   machine, the divide and conquer's pow2-aligned merges from position 0,
   on the CPU and in ``csrc/pav_scan.cu``, and minimax's index-0-aligned
   pairwise scans) runs on bitwise-identical operands.
2. **No isotonic block pools across the real/pad boundary**: the first
   pad sits below the smallest real block value by a margin
   ``M(N) = 132 + 2*log(N+1)``, and each further pad descends by at least
   that margin.
3. **KL stays bitwise too**: the 132 in the margin exceeds the float32
   ``exp`` underflow threshold (~104), so a log-sum-exp that crosses into
   the pad region adds ``exp(pad - acc) == 0.0`` exactly.  The kernels are
   built without ``--use_fast_math`` (``kernels/_build.py``), so their
   ``expf`` underflows to exactly 0 as well.

So ``padded(values)[:, :n]`` equals the unpadded operator bit for bit, per
backend, for soft_sort / soft_rank / soft_topk / projection.  The scalar
losses (Spearman, LTS) are masked reductions over those vectors; their
reduction order differs between ``n`` and ``N``, so they are allclose, not
bitwise.

The unpadded operators divide by ``eps`` rounded to f32, as one division
on every device (``core.operators._div_eps``); the padded ops divide by the
same per-row f32 eps.

Every op takes one signature,

    fn(values (B, N) f32, true_n (B,) int, eps (B,) f32, *extras)

with per-request parameters (``eps``, ``k``, ``trim``) as per-row tensors,
so one bound callable serves any mix of request parameters.  The static
variant (regularization, direction) is baked into module-level
``functools.partial`` objects with a stable identity per process.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable

import torch

from repro_torch.core.projection import projection_permutahedron

#: Extra argument kinds: a scalar per row, or a full (B, N) row vector.
EXTRA_SCALAR = "scalar_per_row"
EXTRA_VECTOR = "row_vector"


def margin(bucket_n: int) -> float:
  """Separation margin between consecutive pad entries.

  128 clears the float32 ``exp`` underflow threshold (exp(x) == 0.0 for
  x < -103.98) with slack; ``2*log(N+1)`` absorbs log-sum-exp
  accumulation over up to N terms on both sides of a KL block value;
  +4 is headroom for the last ulp of masked min/max reductions.
  """
  return 128.0 + 2.0 * math.log(bucket_n + 1.0) + 4.0


def _row_geometry(values: torch.Tensor, true_n: torch.Tensor):
  """(idx, nn, mask, tail_k) for a (B, N) batch.

  ``mask`` is True on real lanes; ``tail_k`` counts pad positions
  1, 2, ... within the pad region (arbitrary <= 0 on real lanes).
  """
  idx = torch.arange(values.shape[-1], device=values.device)[None, :]
  nn = true_n.to(idx.dtype)[:, None]
  mask = idx < nn
  tail_k = (idx - nn + 1).to(values.dtype)
  return idx, nn, mask, tail_k


def _masked_min(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
  return torch.amin(torch.where(mask, x, math.inf), dim=-1, keepdim=True)


def _masked_max(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
  return torch.amax(torch.where(mask, x, -math.inf), dim=-1, keepdim=True)


# ---------------------------------------------------------------------------
# The padded operators.
#
# Shared shape of the argument: the real prefix reproduces the unpadded
# operator's (z, w) bit for bit; the pad tail extends z strictly
# descending with a per-step drop of at least margin(N) (plus the weights'
# range where they vary), and extends w weakly descending strictly below
# the real weights.
# ---------------------------------------------------------------------------


def _padded_soft_sort(values, true_n, eps, *, regularization: str,
                      direction: str, impl=None, plan=None):
  """Bucket-padded soft_sort; out[:, :n] bitwise == unpadded soft_sort."""
  descending = direction == "DESCENDING"
  vv = values if descending else -values
  idx, nn, mask, tail_k = _row_geometry(values, true_n)
  # Real prefix: z = rho_n / eps exactly ((n - idx) is integer-exact in
  # f32).  Pads keep descending by 1/eps + D per step.
  z_ladder = (nn - idx).to(values.dtype) / eps[:, None]
  mn_v = _masked_min(vv, mask)
  d_step = (_masked_max(vv, mask) - mn_v) + margin(values.shape[-1])
  z = torch.where(mask, z_ladder, z_ladder - tail_k * d_step)
  w = torch.where(mask, vv, mn_v - 1.0)
  out = projection_permutahedron(z, w, regularization, impl, plan=plan,
                                 z_is_sorted=True)
  out = out if descending else -out
  return torch.where(mask, out, 0.0)


def _padded_soft_rank(values, true_n, eps, *, regularization: str,
                      direction: str, impl=None, plan=None):
  """Bucket-padded soft_rank; out[:, :n] bitwise == unpadded soft_rank."""
  descending = direction == "DESCENDING"
  idx, nn, mask, tail_k = _row_geometry(values, true_n)
  z_real = (-values if descending else values) / eps[:, None]
  # Whole-row weight ladder (n, n-1, ..., 1, 0, -1, ...): the real prefix
  # is exactly rho_n and the tail keeps strictly descending, so
  # w_is_sorted holds for the full bucket row.
  w = (nn - idx).to(values.dtype)
  mn_z = _masked_min(z_real, mask)
  d_step = values.shape[-1] + margin(values.shape[-1])
  z = torch.where(mask, z_real, mn_z - tail_k * d_step)
  out = projection_permutahedron(z, w, regularization, impl, plan=plan,
                                 w_is_sorted=True)
  return torch.where(mask, out, 0.0)


def _padded_soft_topk(values, true_n, eps, k, *, regularization: str,
                      impl=None, plan=None):
  """Bucket-padded soft_topk_mask with a per-row k."""
  idx, nn, mask, tail_k = _row_geometry(values, true_n)
  z_real = values / eps[:, None]
  # k ones then zeros: pads fall in the zero region, so the whole-row
  # indicator is the real weight vector extended by (exact) zeros.
  w = (idx < k.to(idx.dtype)[:, None]).to(values.dtype)
  mn_z = _masked_min(z_real, mask)
  z = torch.where(mask, z_real,
                  mn_z - tail_k * margin(values.shape[-1]))
  out = projection_permutahedron(z, w, regularization, impl, plan=plan,
                                 w_is_sorted=True)
  return torch.where(mask, out, 0.0)


def _padded_projection(values, true_n, eps, w, *, regularization: str,
                       impl=None, plan=None):
  """Bucket-padded generic P_Psi(z, w); ``values`` is z, ``eps`` unused
  (kept for the uniform serving signature)."""
  del eps
  _, _, mask, tail_k = _row_geometry(values, true_n)
  mn_z = _masked_min(values, mask)
  mn_w = _masked_min(w, mask)
  d_step = (_masked_max(w, mask) - mn_w) + margin(values.shape[-1])
  z_pad = torch.where(mask, values, mn_z - tail_k * d_step)
  w_pad = torch.where(mask, w, mn_w - 1.0)
  out = projection_permutahedron(z_pad, w_pad, regularization, impl,
                                 plan=plan)
  return torch.where(mask, out, 0.0)


def _padded_spearman(values, true_n, eps, target, *, regularization: str,
                     direction: str, impl=None, plan=None):
  """Per-row soft Spearman loss over bucket-padded rows: a masked sum over
  the exact padded soft_rank, allclose to the unpadded loss."""
  ranks = _padded_soft_rank(values, true_n, eps,
                            regularization=regularization,
                            direction=direction, impl=impl, plan=plan)
  _, _, mask, _ = _row_geometry(values, true_n)
  sq = torch.where(mask, (ranks - target) ** 2, 0.0)
  return 0.5 * torch.sum(sq, dim=-1)


def _padded_lts(values, true_n, eps, trim, *, regularization: str,
                impl=None, plan=None):
  """Per-row soft least-trimmed-squares loss over bucket-padded rows."""
  s = _padded_soft_sort(values, true_n, eps, regularization=regularization,
                        direction="DESCENDING", impl=impl, plan=plan)
  idx, _, mask, _ = _row_geometry(values, true_n)
  kept = mask & (idx >= trim.to(idx.dtype)[:, None])
  total = torch.sum(torch.where(kept, s, 0.0), dim=-1)
  return total / (true_n - trim).to(values.dtype)


# ---------------------------------------------------------------------------
# Registry.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class OpSpec:
  """One servable (op, regularization, direction) variant.

  ``fn`` has the signature ``fn(values, true_n, eps, *extras, impl=...,
  plan=...)`` and is a module-level ``functools.partial`` (stable identity
  per process).
  """

  op: str
  regularization: str
  direction: str                       # "" when the op has no direction
  extras: tuple[tuple[str, str, str], ...]  # (name, dtype, kind)
  output: str                          # "vector" | "scalar"
  exact: bool                          # bitwise padding contract holds
  fn: Callable

  @property
  def key(self) -> str:
    parts = [self.op, self.regularization]
    if self.direction:
      parts.append("desc" if self.direction == "DESCENDING" else "asc")
    return "/".join(parts)


def _specs() -> dict[str, OpSpec]:
  out: dict[str, OpSpec] = {}

  def add(spec: OpSpec):
    out[spec.key] = spec

  for reg in ("l2", "kl"):
    for direction in ("DESCENDING", "ASCENDING"):
      add(OpSpec("soft_sort", reg, direction, (), "vector", True,
                 functools.partial(_padded_soft_sort, regularization=reg,
                                   direction=direction)))
      add(OpSpec("soft_rank", reg, direction, (), "vector", True,
                 functools.partial(_padded_soft_rank, regularization=reg,
                                   direction=direction)))
      add(OpSpec("spearman", reg, direction,
                 (("target", "float32", EXTRA_VECTOR),), "scalar", False,
                 functools.partial(_padded_spearman, regularization=reg,
                                   direction=direction)))
    add(OpSpec("soft_topk", reg, "",
               (("k", "int32", EXTRA_SCALAR),), "vector", True,
               functools.partial(_padded_soft_topk, regularization=reg)))
    add(OpSpec("projection", reg, "",
               (("w", "float32", EXTRA_VECTOR),), "vector", True,
               functools.partial(_padded_projection, regularization=reg)))
    add(OpSpec("lts", reg, "",
               (("trim", "int32", EXTRA_SCALAR),), "scalar", False,
               functools.partial(_padded_lts, regularization=reg)))
  return out


#: key ("soft_sort/l2/desc", "lts/kl", ...) -> OpSpec
SERVING_OPS: dict[str, OpSpec] = _specs()


def padded_op(key: str) -> OpSpec:
  """Look up an OpSpec by its key, with a helpful error."""
  try:
    return SERVING_OPS[key]
  except KeyError:
    raise KeyError(
        f"unknown serving op {key!r}; expected one of "
        f"{sorted(SERVING_OPS)}") from None


@functools.lru_cache(maxsize=None)
def bound_op(key: str, impl: str | None = None, plan=None) -> Callable:
  """``spec.fn`` with backend and plan pinned, with a stable identity: the
  same (key, impl, plan) gives the same callable object
  (``ExecutionPlan`` is hashable)."""
  spec = padded_op(key)
  return functools.partial(spec.fn, impl=impl, plan=plan)
