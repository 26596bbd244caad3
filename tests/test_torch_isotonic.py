"""Port of ``repro.core.isotonic``: forward and VJP parity.

``isotonic_l2`` / ``isotonic_kl`` of the port (plain stack machine on the
CPU) against the reference's (minimax backend, jitted), through
``jax.vjp`` and ``torch.autograd.grad``: batches with ties and constant
rows, n = 1, unbatched and batched ``w``, f32 and f64.  Tolerances: see
``test_torch_common``.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_common import (  # noqa: E402
    as_torch,
    assert_vjp_parity,
    rows_with_ties,
    sorted_desc,
)

from repro.core import isotonic as jiso  # noqa: E402
from repro_torch.core import isotonic as iso  # noqa: E402

rng = np.random.default_rng(23)


@pytest.mark.parametrize("shape", [(4, 10), (3, 1)])
@pytest.mark.parametrize("f64", [False, True])
def test_isotonic_l2_fwd_and_vjp(shape, f64):
  y = rows_with_ties(rng, *shape)
  assert_vjp_parity(lambda a: jiso.isotonic_l2(a, "minimax"),
                    iso.isotonic_l2, (y,), rng.normal(size=shape), f64=f64)


@pytest.mark.parametrize("w_batched", [False, True])
@pytest.mark.parametrize("f64", [False, True])
def test_isotonic_kl_fwd_and_vjp(w_batched, f64):
  s = sorted_desc(rows_with_ties(rng, 4, 10))
  w = sorted_desc(rng.normal(size=(4, 10) if w_batched else (10,)))
  _, (_, g_w) = assert_vjp_parity(
      lambda a, b: jiso.isotonic_kl(a, b, "minimax"), iso.isotonic_kl,
      (s, w), rng.normal(size=s.shape), f64=f64)
  assert g_w.shape == w.shape   # an unbatched w gets an unbatched gradient


def test_isotonic_kl_n1():
  s, w = rng.normal(size=(3, 1)), rng.normal(size=(3, 1))
  assert_vjp_parity(lambda a, b: jiso.isotonic_kl(a, b, "minimax"),
                    iso.isotonic_kl, (s, w), rng.normal(size=(3, 1)))


@pytest.mark.parametrize("impl", ["stack", "minimax"])
def test_isotonic_backends_agree_under_autograd(impl):
  """The port's own backends give the same VJP (the backward is shared)."""
  y = as_torch(rows_with_ties(rng, 3, 8), grad=True)
  g = torch.randn(3, 8, generator=torch.Generator().manual_seed(0))
  v = iso.isotonic_l2(y, impl)
  (gy,) = torch.autograd.grad(v, y, g)
  v0 = iso.isotonic_l2(y.detach(), "stack")
  assert torch.allclose(v, v0, atol=1e-5) and gy.shape == y.shape
  # Lemma 2: the l2 VJP is the within-block mean of g, so sums match.
  assert torch.allclose(gy.sum(-1), g.sum(-1), atol=1e-5)
