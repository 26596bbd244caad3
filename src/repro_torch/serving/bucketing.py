"""Shape-bucket policy: which padded width serves a request of size n.

Counterpart of ``repro.serving.bucketing``.  Buckets trade the number of
warmed cells against padding waste: the engine quantizes request sizes onto
a small ladder (default: powers of two) and batch sizes onto a pow2 row
ladder up to ``max_batch``, and warms every (rows, bucket) cell once.

``BucketPolicy.from_plan`` splices the governing
:class:`repro_torch.plan.ExecutionPlan`'s shape breakpoints into the
ladder, so no bucket straddles a backend cutoff: a request that the plan
would route to the small-n backend is never padded past the cutoff into
the large-n backend's regime.
"""

from __future__ import annotations

import dataclasses

from repro_torch import plan as plan_mod


def _pow2_ladder(lo: int, hi: int) -> tuple[int, ...]:
  if lo < 1 or hi < lo:
    raise ValueError(f"invalid ladder bounds [{lo}, {hi}]")
  sizes = []
  b = 1
  while b < lo:
    b *= 2
  while b < hi:
    sizes.append(b)
    b *= 2
  sizes.append(hi)
  return tuple(sizes)


@dataclasses.dataclass(frozen=True)
class BucketPolicy:
  """Sorted ladders of padded problem sizes and batch-row sizes."""

  sizes: tuple[int, ...]
  row_sizes: tuple[int, ...]

  def __post_init__(self):
    for name, ladder in (("sizes", self.sizes), ("row_sizes", self.row_sizes)):
      if not ladder or list(ladder) != sorted(set(ladder)):
        raise ValueError(f"{name} must be a non-empty sorted unique ladder, "
                         f"got {ladder!r}")
      if ladder[0] < 1:
        raise ValueError(f"{name} entries must be >= 1, got {ladder!r}")

  @classmethod
  def pow2(cls, min_n: int = 64, max_n: int = 4096,
           max_batch: int = 64) -> "BucketPolicy":
    """Power-of-two ladder: min_n, 2*min_n, ..., max_n; rows 1..max_batch."""
    return cls(sizes=_pow2_ladder(min_n, max_n),
               row_sizes=_pow2_ladder(1, max_batch))

  @classmethod
  def from_plan(cls, plan=None, *, min_n: int = 64, max_n: int = 4096,
                max_batch: int = 64) -> "BucketPolicy":
    """pow2 ladder refined with the plan chain's n-breakpoints.

    ``plan=None`` uses whatever plan currently governs dispatch (active >
    packaged default > builtin), mirroring the resolution chain.
    """
    base = set(_pow2_ladder(min_n, max_n))
    for edge in plan_mod.shape_breakpoints(plan):
      if min_n <= edge <= max_n:
        base.add(edge)
    sizes = tuple(sorted(base))
    return cls(sizes=sizes, row_sizes=_pow2_ladder(1, max_batch))

  @property
  def max_n(self) -> int:
    return self.sizes[-1]

  @property
  def max_rows(self) -> int:
    return self.row_sizes[-1]

  def bucket_for(self, n: int) -> int:
    """Smallest bucket >= n; raises for n out of the serviceable range."""
    if n < 1:
      raise ValueError(f"request size must be >= 1, got {n}")
    for b in self.sizes:
      if n <= b:
        return b
    raise ValueError(
        f"request size n={n} exceeds the largest bucket {self.sizes[-1]}")

  def rows_for(self, m: int) -> int:
    """Smallest row bucket >= m (m is clamped to max_rows by callers)."""
    if m < 1:
      raise ValueError(f"row count must be >= 1, got {m}")
    for b in self.row_sizes:
      if m <= b:
        return b
    raise ValueError(
        f"row count {m} exceeds the largest row bucket {self.row_sizes[-1]}")
