"""Port of ``repro.core.losses``: forward and VJP parity.

Every loss of the port (plain backends on the CPU) against the reference's
(composed projection, jitted), and the hard metrics against theirs.
Tolerances: see ``test_torch_common``.
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
    rows_with_ties,
)

import repro.core as jcore  # noqa: E402
import repro_torch.core as core  # noqa: E402

rng = np.random.default_rng(59)
pytestmark = pytest.mark.usefixtures("composed_ref")

SHAPE = (4, 10)


def _targets(shape) -> np.ndarray:
  return rng.permuted(np.broadcast_to(np.arange(1.0, shape[-1] + 1), shape),
                      axis=-1).copy()


@pytest.mark.parametrize("reg", ["l2", "kl"])
@pytest.mark.parametrize("direction", ["ASCENDING", "DESCENDING"])
def test_soft_spearman_loss(reg, direction):
  x, t = rows_with_ties(rng, *SHAPE), _targets(SHAPE)
  assert_vjp_parity(
      lambda a: jcore.soft_spearman_loss(a, t, 0.5, reg, direction),
      lambda a: core.soft_spearman_loss(a, as_torch(t), 0.5, reg, direction),
      (x,), np.float64(1.0))


@pytest.mark.parametrize("reg", ["l2", "kl"])
def test_soft_topk_loss(reg):
  x = rng.normal(size=SHAPE)
  labels = rng.integers(0, SHAPE[1], size=SHAPE[0])
  assert_vjp_parity(
      lambda a: jcore.soft_topk_loss(a, jnp.asarray(labels), 3, 0.5, reg),
      lambda a: core.soft_topk_loss(a, torch.as_tensor(labels), 3, 0.5, reg),
      (x,), np.float64(1.0))


@pytest.mark.parametrize("reg", ["l2", "kl"])
def test_soft_lts_loss(reg):
  x = np.abs(rows_with_ties(rng, *SHAPE))
  assert_vjp_parity(lambda a: jcore.soft_lts_loss(a, 3, 0.5, reg),
                    lambda a: core.soft_lts_loss(a, 3, 0.5, reg),
                    (x,), rng.normal(size=SHAPE[:1]))


@pytest.mark.parametrize("trim", [0.0, 0.25])
def test_soft_trimmed_token_loss(trim):
  x = np.abs(rng.normal(size=(3, 8)))
  assert_vjp_parity(lambda a: jcore.soft_trimmed_token_loss(a, trim, 0.5),
                    lambda a: core.soft_trimmed_token_loss(a, trim, 0.5),
                    (x,), np.float64(1.0))


def test_hard_metrics():
  x, t = rows_with_ties(rng, *SHAPE), _targets(SHAPE)
  labels = rng.integers(0, SHAPE[1], size=SHAPE[0])
  j = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
  for direction in ("ASCENDING", "DESCENDING"):
    np.testing.assert_array_equal(
        core.hard_rank(as_torch(x), direction).numpy(),
        np.asarray(jcore.hard_rank(j(x), direction)))
  assert_close(core.spearman_correlation(as_torch(x), as_torch(t)),
               jax.jit(jcore.spearman_correlation)(j(x), j(t)), x, t)
  for k in (1, 3):
    assert float(core.topk_accuracy(as_torch(x), torch.as_tensor(labels),
                                    k)) == float(
        jcore.topk_accuracy(j(x), jnp.asarray(labels), k))
