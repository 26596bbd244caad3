"""Port of the Lemma 2 backward (``scatter`` formulation) and block recovery.

Each function of ``repro_torch.kernels.segment_vjp`` against its namesake in
``repro.kernels.segment_vjp`` on the same block structures: random blocks,
one block per row, all singletons, and n = 1.  Tolerances: see
``test_torch_common``; block structure and indices must be equal.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_common import as_torch, assert_close  # noqa: E402

from repro.kernels import segment_vjp as jsvjp  # noqa: E402
from repro_torch.kernels import segment_vjp as svjp  # noqa: E402

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


def test_block_sums_do_not_cancel_on_a_long_row():
  """A 2**16-long row of large values with one small block at its end:
  a difference of cumulative sums would lose the small block's mean."""
  n = 2**16
  g = np.full((1, n), 1024.0)
  g[0, -4:] = [1e-3, 2e-3, 3e-3, 4e-3]
  v = np.concatenate([np.zeros(n - 4), -np.ones(4)])[None]
  got = svjp.isotonic_l2_bwd_scatter(as_torch(v), as_torch(g))
  np.testing.assert_allclose(got[0, -4:].numpy(), 2.5e-3, rtol=1e-6)
  np.testing.assert_allclose(got[0, 0].item(), 1024.0, rtol=1e-6)
