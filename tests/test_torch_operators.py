"""Port of ``repro.core.operators``: forward and VJP parity, and invariants.

Every operator of the port (plain backends on the CPU) against the
reference's (composed projection, minimax backend, jitted): both
regularizations, ASCENDING and DESCENDING, ties and constant rows, f64 and
bf16, the Lemma 3 exact regime, and ``SortContext`` reuse.  Then the
properties ``tests/test_property_hypothesis.py`` states for the reference,
on the port.  Tolerances: see ``test_torch_common``.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_common import (  # noqa: E402
    CONTRACT_BF16,
    as_torch,
    assert_close,
    assert_vjp_parity,
    composed_ref,  # noqa: F401
    cuda_device,  # noqa: F401
    rows_with_ties,
    sorted_desc,
)

import repro.core as jcore  # noqa: E402
import repro_torch.core as core  # noqa: E402

rng = np.random.default_rng(47)
pytestmark = pytest.mark.usefixtures("composed_ref")

SHAPE = (4, 10)


def _both(name, **kwargs):
  """(reference fn with impl=minimax, port fn) of operator ``name``."""
  return (functools.partial(getattr(jcore, name), impl="minimax", **kwargs),
          functools.partial(getattr(core, name), **kwargs))


@pytest.mark.parametrize("op", ["soft_sort", "soft_rank"])
@pytest.mark.parametrize("reg", ["l2", "kl"])
@pytest.mark.parametrize("direction", ["DESCENDING", "ASCENDING"])
def test_sort_and_rank(op, reg, direction):
  x = rows_with_ties(rng, *SHAPE)
  assert_vjp_parity(*_both(op, regularization_strength=0.5,
                           regularization=reg, direction=direction),
                    (x,), rng.normal(size=SHAPE))


@pytest.mark.parametrize("op", ["soft_sort", "soft_rank"])
def test_sort_and_rank_f64(op):
  x = rows_with_ties(rng, *SHAPE)
  assert_vjp_parity(*_both(op, regularization_strength=0.5,
                           regularization="kl"),
                    (x,), rng.normal(size=SHAPE), f64=True)


@pytest.mark.parametrize("direction", ["DESCENDING", "ASCENDING"])
def test_soft_rank_kl_direct(direction):
  x = rows_with_ties(rng, *SHAPE)
  assert_vjp_parity(*_both("soft_rank_kl_direct", regularization_strength=0.5,
                           direction=direction),
                    (x,), rng.normal(size=SHAPE))


@pytest.mark.parametrize("reg", ["l2", "kl"])
def test_soft_topk_mask(reg):
  x = rows_with_ties(rng, *SHAPE)
  ref, port = _both("soft_topk_mask", k=3, regularization_strength=0.5,
                    regularization=reg)
  if reg == "kl":
    # Tied scores against the tied weights (1, 1, 1, 0, ...) give kl
    # blocks whose values tie exactly; whether two of them pool then hangs
    # on the last bit of logaddexp, which differs between implementations,
    # and the Lemma 2 backward reads blocks from exact equality.  Hold the
    # values on the tied batch and the VJP on distinct scores.
    assert_close(port(as_torch(x)), jax.jit(ref)(jnp.asarray(x, jnp.float32)),
                 x)
    x = rng.normal(size=SHAPE)
  assert_vjp_parity(ref, port, (x,), rng.normal(size=SHAPE))
  mask = port(as_torch(x))
  if reg == "l2":   # the l2 mask lies in [0, 1]^n and sums to k
    assert torch.allclose(mask.sum(-1), torch.full((SHAPE[0],), 3.0),
                          atol=1e-5)
    assert bool(((mask >= -1e-6) & (mask <= 1 + 1e-6)).all())


def test_soft_quantile():
  x = rows_with_ties(rng, *SHAPE)
  assert_vjp_parity(*_both("soft_quantile", q=0.5,
                           regularization_strength=0.2),
                    (x,), rng.normal(size=SHAPE[:1]))


def test_single_element_rows():
  x = rng.normal(size=(3, 1))
  assert_vjp_parity(*_both("soft_rank", regularization_strength=0.5),
                    (x,), rng.normal(size=(3, 1)))


def test_eps_min_and_eps_max():
  s = sorted_desc(rng.normal(size=SHAPE))
  w = np.broadcast_to(np.arange(SHAPE[1], 0, -1.0), SHAPE)
  j = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
  assert_close(core.eps_min(as_torch(s), as_torch(w)),
               jax.jit(jcore.eps_min)(j(s), j(w)), s)
  assert_close(core.eps_max(as_torch(s), as_torch(w)),
               jax.jit(jcore.eps_max)(j(s), j(w)), s)


@pytest.mark.parametrize("reg", ["l2", "kl"])
def test_lemma3_exact_regime(reg):
  """For eps <= eps_min the soft rank and sort are exactly hard."""
  theta = rng.normal(size=(6,)) * 2
  rho = torch.arange(6, 0, -1.0)
  s = torch.sort(as_torch(-theta), descending=True).values
  eps = 0.5 * float(core.eps_min(s, rho))
  hard = core.hard_rank(as_torch(theta), "DESCENDING")
  np.testing.assert_allclose(core.soft_rank(as_torch(theta), eps, reg),
                             hard, atol=1e-3)
  w_sorted = torch.sort(as_torch(theta), descending=True).values
  eps_s = min(0.5 * float(core.eps_min(rho, w_sorted)), 0.5)
  np.testing.assert_allclose(core.soft_sort(as_torch(theta), eps_s, reg),
                             w_sorted, atol=1e-3)


@pytest.mark.parametrize("op", ["soft_sort", "soft_rank"])
def test_bf16_in_and_out(op):
  """bf16 in, bf16 out; held against the reference's bf16 result."""
  x = rng.normal(size=(2, 9))
  ref, port = _both(op, regularization_strength=0.5)
  want = jax.jit(ref)(jnp.asarray(x, jnp.bfloat16))
  got = port(as_torch(x, torch.bfloat16))
  assert got.dtype == torch.bfloat16
  assert_close(got, np.asarray(want, np.float32), x, 9,
               contract=CONTRACT_BF16)


def test_sort_context_shares_one_sort():
  """Operators fed a SortContext give the same values and gradients."""
  x = as_torch(rows_with_ties(rng, *SHAPE), grad=True)
  ctx = core.SortContext(x)
  for fn in (lambda v, **k: core.soft_rank(v, 0.5, **k),
             lambda v, **k: core.soft_rank(v, 0.5, direction="ASCENDING", **k),
             lambda v, **k: core.soft_sort(v, 0.5, "kl", **k),
             lambda v, **k: core.soft_topk_mask(v, 2, 0.5, **k)):
    a, b = fn(x), fn(x, sort_context=ctx)
    assert torch.allclose(a, b, atol=1e-5)
    ga, = torch.autograd.grad(a.square().sum(), x)
    gb, = torch.autograd.grad(b.square().sum(), x)
    assert torch.allclose(ga, gb, atol=1e-5)


# ---------------------------------------------------------------------------
# Properties of the reference (tests/test_property_hypothesis.py), on the port.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reg", ["l2", "kl"])
def test_rank_properties(reg):
  x = as_torch(rng.normal(size=(5, 12)) * 2)
  n = x.shape[-1]
  r = core.soft_rank(x, 0.7, reg)
  if reg == "l2":   # the permutahedron: ranks sum to n(n+1)/2
    assert torch.allclose(r.sum(-1), torch.full((5,), n * (n + 1) / 2.0),
                          atol=1e-4)
  # translation invariance, scaling, and permutation equivariance
  assert torch.allclose(core.soft_rank(x + 3.0, 0.7, reg), r, atol=1e-4)
  assert torch.allclose(core.soft_rank(3.0 * x, 0.7, reg),
                        core.soft_rank(x, 0.7 / 3.0, reg), atol=1e-4)
  perm = torch.randperm(n, generator=torch.Generator().manual_seed(1))
  assert torch.allclose(core.soft_rank(x[:, perm], 0.7, reg), r[:, perm],
                        atol=1e-4)
  # ranks are ordered as the values are (descending: rank 1 = largest)
  order = torch.argsort(x, dim=-1, descending=True)
  assert bool((torch.diff(torch.gather(r, -1, order), dim=-1) >= -1e-5)
              .all())


def test_sort_properties():
  x = as_torch(rng.normal(size=(5, 12)))
  s = core.soft_sort(x, 0.7)
  assert bool((torch.diff(s, dim=-1) <= 1e-6).all())   # non-increasing
  assert torch.allclose(s.sum(-1), x.sum(-1), atol=1e-4)   # sum conserved
  # scaling: s_eps(c * x) = P(rho / eps, c * x) = c * s_{c * eps}(x)
  assert torch.allclose(core.soft_sort(2.0 * x, 0.7), 2.0 * core.soft_sort(
      x, 1.4), atol=1e-4)


def test_eps_division_is_a_division():
  """The operators' z = x / eps is one division: on the CPU the same as
  dividing by the scalar (eps rounded to the tensor's dtype)."""
  from repro_torch.core.operators import _div_eps
  x = as_torch(rng.normal(size=(3, 50)) * 7)
  for eps in (0.7, 2.9, 1.2897623193945442, 1e-3):
    assert torch.equal(_div_eps(x, eps), x / eps)
    assert torch.equal(_div_eps(x.double(), eps), x.double() / eps)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("op", ["soft_sort", "soft_rank"])
def test_eps_division_on_the_card_is_the_cpus(op, cuda_device):
  """On the card z = x / eps equals the CPU's bit for bit (PyTorch's CUDA
  division by a Python scalar would multiply by the rounded reciprocal,
  an ulp of n / eps off, which is 1e-4 of soft_sort's output at n / eps
  = 6000), so the operator on the card (the l2 kernel) equals the CPU's
  ``scan`` backend (the kernel's plain version) bit for bit."""
  from repro_torch.core.operators import _div_eps
  x = rng.normal(size=(4, 700))
  for eps in (2.9, 1.2897623193945442, 0.11014354978460848):
    xt = as_torch(x)
    assert torch.equal(_div_eps(xt.to(cuda_device), eps).cpu(), xt / eps)
    got = getattr(core, op)(xt.to(cuda_device), eps).cpu()
    assert torch.equal(got, getattr(core, op)(xt, eps, impl="scan"))
