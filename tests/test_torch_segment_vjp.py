"""Port of the Lemma 2 backward (``segscan`` and ``scatter``) and block
recovery.

Each function of ``repro_torch.kernels.segment_vjp`` against its namesake in
``repro.kernels.segment_vjp`` on the same block structures: random blocks,
one block per row, all singletons, and n = 1; ``segscan`` also against the
port's ``scatter``.  Tolerances: see ``test_torch_common`` (1e-5 * (1 +
max|input|)); block structure and indices must be equal.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_common import (  # noqa: E402
    as_torch,
    assert_close,
    assert_vjp_parity,
    composed_ref,  # noqa: F401
)

from repro.core import operators as jops  # noqa: E402
from repro.kernels import segment_vjp as jsvjp  # noqa: E402
from repro_torch.core import operators as ops  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels import segment_vjp as svjp  # noqa: E402
from repro_torch.obs import metrics  # noqa: E402

rng = np.random.default_rng(5)


def _block_values(n: int) -> np.ndarray:
  """Non-increasing (3, n) values whose runs of equal values are blocks:
  random blocks, one block, all singletons."""
  cuts = rng.random(n) < 0.4
  cuts[0] = True
  return np.stack([-np.cumsum(cuts).astype(np.float64), np.full(n, 2.5),
                   -np.arange(n, dtype=np.float64)])


CASES = [12, 1]   # n


@pytest.mark.parametrize("n", CASES)
def test_block_structure_matches_reference(n):
  v = _block_values(n)
  vj, vt = jnp.asarray(v, jnp.float32), as_torch(v)
  starts = svjp.block_starts(vt)
  np.testing.assert_array_equal(starts.numpy(),
                                np.asarray(jsvjp.block_starts(vj)))
  np.testing.assert_array_equal(svjp.block_ids(vt).numpy(),
                                np.asarray(jsvjp.block_ids(vj)))
  si, ei = svjp.start_end_indices(starts)
  jsi, jei = jsvjp.start_end_indices(jsvjp.block_starts(vj))
  np.testing.assert_array_equal(si.numpy(), np.asarray(jsi))
  np.testing.assert_array_equal(ei.numpy(), np.asarray(jei))


@pytest.mark.parametrize("n", CASES)
def test_isotonic_backward_matches_reference(n):
  v = _block_values(n)
  s, w, g = (rng.normal(size=v.shape) for _ in range(3))
  j = lambda x: jnp.asarray(x, jnp.float32)  # noqa: E731
  want_l2 = jax.jit(jsvjp.isotonic_l2_bwd_scatter)(j(v), j(g))
  want_s, want_w = jax.jit(jsvjp.isotonic_kl_bwd_scatter)(j(s), j(w), j(v),
                                                          j(g))
  got_l2 = svjp.isotonic_l2_bwd_scatter(as_torch(v), as_torch(g))
  got_s, got_w = svjp.isotonic_kl_bwd_scatter(as_torch(s), as_torch(w),
                                              as_torch(v), as_torch(g))
  assert_close(got_l2, want_l2, g)
  assert_close(got_s, want_s, s, w, g)
  assert_close(got_w, want_w, s, w, g)


def test_projection_backward_matches_reference():
  """The fused projection's backward reads the saved start mask."""
  v = _block_values(12)
  s, w, g = (rng.normal(size=v.shape) for _ in range(3))
  starts_t = svjp.block_starts(as_torch(v))
  j = lambda x: jnp.asarray(x, jnp.float32)  # noqa: E731
  starts_j = jsvjp.block_starts(j(v))
  jsi, jei = jsvjp.start_end_indices(starts_j)
  want_l2 = jax.jit(jsvjp.projection_l2_bwd_scatter)(j(g), starts_j, jsi, jei)
  want_s, want_w = jax.jit(jsvjp.projection_kl_bwd_scatter)(
      j(s), j(w), j(g), starts_j, jsi, jei)
  assert_close(svjp.projection_l2_bwd_scatter(as_torch(g), starts_t),
               want_l2, g)
  got_s, got_w = svjp.projection_kl_bwd_scatter(
      as_torch(s), as_torch(w), as_torch(g), starts_t)
  assert_close(got_s, want_s, s, w, g)
  assert_close(got_w, want_w, s, w, g)


@pytest.mark.parametrize("n", CASES)
def test_segscan_matches_scatter_and_reference(n):
  """Every ``segscan`` backward, isotonic and projection, l2 and kl, against
  the reference's ``segscan`` and the port's ``scatter`` on the same
  blocks (ties: runs of equal values)."""
  v = _block_values(n)
  s, w, g = (rng.normal(size=v.shape) for _ in range(3))
  j = lambda x: jnp.asarray(x, jnp.float32)  # noqa: E731
  vt, st, wt, gt = map(as_torch, (v, s, w, g))
  starts_t = svjp.block_starts(vt)
  starts_j = jsvjp.block_starts(j(v))
  jsi, jei = jsvjp.start_end_indices(starts_j)
  cases = [
      (svjp.isotonic_l2_bwd_segscan(vt, gt),
       jax.jit(jsvjp.isotonic_l2_bwd_segscan)(j(v), j(g)),
       svjp.isotonic_l2_bwd_scatter(vt, gt)),
      (svjp.isotonic_kl_bwd_segscan(st, wt, vt, gt),
       jax.jit(jsvjp.isotonic_kl_bwd_segscan)(j(s), j(w), j(v), j(g)),
       svjp.isotonic_kl_bwd_scatter(st, wt, vt, gt)),
      (svjp.projection_l2_bwd_segscan(gt, starts_t),
       jax.jit(jsvjp.projection_l2_bwd_segscan)(j(g), starts_j, jsi, jei),
       svjp.projection_l2_bwd_scatter(gt, starts_t)),
      (svjp.projection_kl_bwd_segscan(st, wt, gt, starts_t),
       jax.jit(jsvjp.projection_kl_bwd_segscan)(j(s), j(w), j(g), starts_j,
                                                jsi, jei),
       svjp.projection_kl_bwd_scatter(st, wt, gt, starts_t)),
  ]
  for got, want, scatter in cases:
    got, want, scatter = (x if isinstance(x, tuple) else (x,)
                          for x in (got, want, scatter))
    for a, b, c in zip(got, want, scatter):
      assert_close(a, b, s, w, g)
      assert_close(a, c, s, w, g)


def test_block_sums_do_not_cancel_on_a_long_row():
  """A 2**16-long row of large values with one small block at its end:
  a difference of cumulative sums would lose the small block's mean.  Both
  formulations."""
  n = 2**16
  g = np.full((1, n), 1024.0)
  g[0, -4:] = [1e-3, 2e-3, 3e-3, 4e-3]
  v = np.concatenate([np.zeros(n - 4), -np.ones(4)])[None]
  for bwd in (svjp.isotonic_l2_bwd_scatter, svjp.isotonic_l2_bwd_segscan):
    got = bwd(as_torch(v), as_torch(g))
    np.testing.assert_allclose(got[0, -4:].numpy(), 2.5e-3, rtol=1e-6)
    np.testing.assert_allclose(got[0, 0].item(), 1024.0, rtol=1e-6)


@pytest.mark.parametrize("backward", ["segscan", "scatter"])
@pytest.mark.parametrize("reg", ["l2", "kl"])
def test_fused_backward_matches_reference(reg, backward, monkeypatch,
                                          composed_ref):
  """soft_rank's gradient through the fused projection with each backward
  (``REPRO_TORCH_BACKWARD``), rows with ties, against the reference's
  (its default backward is ``segscan``)."""
  monkeypatch.setenv(dispatch.BWD_ENV_VAR, backward)
  metrics.reset()
  x = np.round(rng.normal(size=(4, 10)) * 2) / 2
  assert_vjp_parity(lambda a: jops.soft_rank(a, 0.7, reg),
                    lambda a: ops.soft_rank(a, 0.7, reg), (x,),
                    rng.normal(size=x.shape))
  assert metrics.counter_value("dispatch_bwd_resolve", op="projection",
                               regularization=reg, backend=backward,
                               source="env") == 1
