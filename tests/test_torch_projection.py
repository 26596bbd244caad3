"""Port of ``repro.core.projection``: both paths, forward and VJP parity.

The port's ``fused`` and ``composed`` paths against the reference's
projection (composed path, minimax backend, jitted), with respect to both
``z`` and ``w``: unbatched and batched ``w``, ties, and the sortedness
hints.  Then the Lemma 3 exact regime, the half-precision contract and the
path selection.  Tolerances: see ``test_torch_common``.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_common import (  # noqa: E402
    CONTRACT,
    CONTRACT_BF16,
    as_torch,
    assert_close,
    assert_vjp_parity,
    composed_ref,  # noqa: F401
    rows_with_ties,
    sorted_desc,
)

from repro.core.projection import (  # noqa: E402
    projection_permutahedron as jproj,
)
from repro_torch.core.permutations import SortContext  # noqa: E402
from repro_torch.core.projection import projection_permutahedron  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402

rng = np.random.default_rng(31)
pytestmark = pytest.mark.usefixtures("composed_ref")


@pytest.mark.parametrize("reg", ["l2", "kl"])
@pytest.mark.parametrize("w_batched", [False, True])
def test_projection_paths_match_reference(reg, w_batched):
  z = rows_with_ties(rng, 4, 9) * 3
  w = rng.normal(size=(4, 9) if w_batched else (9,))
  cot = rng.normal(size=z.shape)
  _, (_, g_w) = assert_vjp_parity(
      functools.partial(jproj, regularization=reg, impl="minimax"),
      [functools.partial(projection_permutahedron, regularization=reg,
                         path=path) for path in ("fused", "composed")],
      (z, w), cot)
  assert g_w.shape == w.shape


@pytest.mark.parametrize("reg", ["l2", "kl"])
def test_fused_hints_match_unhinted(reg):
  """z_is_sorted / w_is_sorted / z_perm / w_perm change no value or VJP."""
  z = sorted_desc(rng.normal(size=(3, 8)))
  w = sorted_desc(rng.normal(size=(8,)))
  cot = as_torch(rng.normal(size=z.shape))

  def run(**hints):
    zt, wt = as_torch(z, grad=True), as_torch(w, grad=True)
    out = projection_permutahedron(zt, wt, reg, path="fused", **hints)
    return (out, *torch.autograd.grad(out, (zt, wt), cot))

  want = run()
  ctx_z, ctx_w = SortContext(as_torch(z)), SortContext(as_torch(w))
  for hints in ({"z_is_sorted": True, "w_is_sorted": True},
                {"z_perm": ctx_z.descending()[1:],
                 "w_perm": ctx_w.descending()[1:]}):
    for got, ref in zip(run(**hints), want):
      assert_close(got, ref, z, w, contract=CONTRACT)


@pytest.mark.parametrize("reg", ["l2", "kl"])
def test_lemma3_exact_regime(reg):
  """For eps <= eps_min the projection is exactly the hard one (Lemma 3):
  P(-theta/eps, rho) is the hard rank."""
  theta = rng.normal(size=(6,)) * 2
  rho = np.arange(6, 0, -1.0)
  s = np.sort(-theta)[::-1]
  eps = 0.5 * float(np.min((s[:-1] - s[1:]) / (rho[:-1] - rho[1:])))
  got = projection_permutahedron(as_torch(-theta / eps), as_torch(rho), reg)
  hard = np.empty(6)
  hard[np.argsort(-theta, kind="stable")] = np.arange(1, 7)
  np.testing.assert_allclose(got.numpy(), hard, atol=1e-3)


def test_bf16_runs_promoted_and_returns_bf16():
  z, w = rng.normal(size=(3, 7)), rng.normal(size=(7,))
  got = projection_permutahedron(as_torch(z, torch.bfloat16),
                                 as_torch(w, torch.bfloat16), "l2")
  assert got.dtype == torch.bfloat16
  z32 = as_torch(z, torch.bfloat16).float()
  want = projection_permutahedron(z32, as_torch(w, torch.bfloat16).float())
  assert_close(got, want, z, contract=CONTRACT_BF16)


def test_projection_path_selection(monkeypatch):
  assert dispatch.resolve_projection(None) == "fused"
  monkeypatch.setenv("REPRO_TORCH_PROJECTION", "composed")
  assert dispatch.resolve_projection(None) == "composed"
  assert dispatch.resolve_projection("fused") == "fused"
  monkeypatch.setenv("REPRO_TORCH_PROJECTION", "packed")
  with pytest.raises(ValueError, match="REPRO_TORCH_PROJECTION"):
    dispatch.resolve_projection(None)
  with pytest.raises(ValueError, match="regularization"):
    projection_permutahedron(torch.zeros(3), torch.zeros(3), "entropy")
