"""The port's first slice as a whole: losses through the operator chain.

A Spearman plus soft least-trimmed-squares objective over a batch with two
leading dimensions, differentiated end to end, against the same objective
in the reference (composed projection, minimax solves, jitted).  The chain
is soft rank / soft sort -> projection -> one batched isotonic solve ->
Lemma 2 backward.  Tolerances: see ``test_torch_common``.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from test_torch_common import (  # noqa: E402
    as_torch,
    assert_vjp_parity,
    composed_ref,  # noqa: F401
    rows_with_ties,
)

import repro.core as jcore  # noqa: E402
import repro_torch.core as core  # noqa: E402

SEED = 71   # each test draws its data from its own generator of this seed
pytestmark = pytest.mark.usefixtures("composed_ref")

SHAPE = (2, 3, 12)


def _ref_objective(theta, target, reg):
  spearman = jcore.soft_spearman_loss(theta, target, 0.5, reg)
  residuals = (theta - jnp.mean(theta, axis=-1, keepdims=True)) ** 2
  return spearman + jnp.mean(jcore.soft_lts_loss(residuals, 3, 0.5, reg))


def _port_objective(theta, target, reg):
  spearman = core.soft_spearman_loss(theta, target, 0.5, reg)
  residuals = (theta - theta.mean(dim=-1, keepdim=True)) ** 2
  return spearman + core.soft_lts_loss(residuals, 3, 0.5, reg).mean()


@pytest.mark.parametrize("reg", ["l2", "kl"])
def test_spearman_plus_lts_objective(reg):
  rng = np.random.default_rng(SEED)
  theta = rows_with_ties(rng, 6, 12).reshape(SHAPE)
  target = rng.permuted(np.broadcast_to(np.arange(1.0, 13), SHAPE),
                        axis=-1).copy()
  assert_vjp_parity(
      lambda a: _ref_objective(a, jnp.asarray(target, jnp.float32), reg),
      lambda a: _port_objective(a, as_torch(target), reg),
      (theta,), np.float64(1.0))


def test_cuda_route_raises_on_cpu_tensors():
  """No silent CPU path: asking for the kernels with CPU tensors raises
  at every entry point."""
  rng = np.random.default_rng(SEED)
  x = as_torch(rng.normal(size=(2, 5)), grad=True)
  with pytest.raises(ValueError, match="CUDA"):
    core.soft_rank(x, impl="cuda")
  with pytest.raises(ValueError, match="CUDA"):
    core.soft_sort(x, regularization="kl", impl="cuda")
  with pytest.raises(ValueError, match="CUDA"):
    core.isotonic_l2(x, "cuda")


def test_cuda_env_raises_on_cpu_tensors(monkeypatch):
  monkeypatch.setenv("REPRO_TORCH_BACKEND", "cuda")
  with pytest.raises(ValueError, match="CUDA"):
    core.soft_spearman_loss(torch.randn(2, 5), torch.randn(2, 5))
