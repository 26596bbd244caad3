"""Port of ``repro.core.baselines``: the paper's OT / Sinkhorn and all-pairs
baselines against the reference.

The same numpy inputs and cotangent go through the reference (jitted) and
the port: values and VJPs of ``allpairs_rank``, ``ot_rank`` and ``ot_sort``
on a 1-D row and on a batch, in f32 and in f64 (the reference under
``jax.enable_x64(True)``).  Tolerances: within 1e-5 * (1 + max|want|) in
f32, values and gradients alike (at eps = 1e-2 the unrolled Sinkhorn
gradient of the f32 reference is itself ~1e-5 off its f64 value, a few
ulp of the rank scale); 1e-10 in f64.  Then the reference's own
convergence checks (``tests/test_system.py``) on the port: OT at eps = 1e-3
with 400 iterations within 0.05 of the hard ranks, all-pairs at tau =
1e-3 within 1e-3.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from test_torch_common import (  # noqa: E402
    CONTRACT,
    CONTRACT_F64,
    assert_close,
    jax_vjp,
    torch_vjp,
)

from repro.core import baselines as jbaselines  # noqa: E402
import repro_torch.core as core  # noqa: E402
from repro_torch.core import baselines  # noqa: E402

# name: (function name, keyword arguments): the benchmark's settings (tau
# 0.1; eps 1e-2, here at 50 iterations) and a smoother eps.
FUNCS = {
    "allpairs_tau0.1": ("allpairs_rank", dict(temperature=0.1)),
    "allpairs_tau1": ("allpairs_rank", dict()),
    "ot_rank_eps1e-2": ("ot_rank", dict(epsilon=1e-2, num_iters=50)),
    "ot_rank_eps0.1": ("ot_rank", dict(epsilon=0.1, num_iters=30)),
    "ot_sort_eps1e-2": ("ot_sort", dict(epsilon=1e-2, num_iters=50)),
}
SHAPES = {"row": (11,), "batch": (3, 9)}


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("f64", [False, True], ids=["f32", "f64"])
@pytest.mark.parametrize("func", sorted(FUNCS))
def test_baseline_matches_reference(func, f64, shape):
  name, kwargs = FUNCS[func]
  rng = np.random.default_rng([71, len(func), f64, len(shape)])
  x = rng.normal(size=SHAPES[shape])
  cot = rng.normal(size=x.shape)
  jfn = lambda t: getattr(jbaselines, name)(t, **kwargs)
  tfn = lambda t: getattr(baselines, name)(t, **kwargs)
  if f64:
    with jax.enable_x64(True):
      want, (want_g,) = jax_vjp(jfn, (x,), cot, np.float64)
    got, (got_g,) = torch_vjp(tfn, (x,), cot, torch.float64)
  else:
    want, (want_g,) = jax_vjp(jfn, (x,), cot)
    got, (got_g,) = torch_vjp(tfn, (x,), cot)
  dtype = torch.float64 if f64 else torch.float32
  assert got.dtype == got_g.dtype == dtype
  assert want.dtype == want_g.dtype == (np.float64 if f64 else np.float32)
  contract = CONTRACT_F64 if f64 else CONTRACT
  assert_close(got, want, want, contract=contract)
  assert_close(got_g, want_g, want_g, contract=contract)


def test_ot_rank_and_sort_is_both():
  x = torch.from_numpy(np.random.default_rng(72).normal(size=(2, 7)))
  ranks, values = baselines.ot_rank_and_sort(x, 0.1, 20)
  assert torch.equal(ranks, baselines.ot_rank(x, 0.1, 20))
  assert torch.equal(values, baselines.ot_sort(x, 0.1, 20))


THETA = [0.3, -1.2, 2.0, 0.9]


@pytest.mark.parametrize("f64", [False, True], ids=["f32", "f64"])
def test_ot_baseline_converges_to_hard_ranks(f64):
  theta = torch.tensor(THETA, dtype=torch.float64 if f64 else torch.float32)
  r = baselines.ot_rank(theta, epsilon=1e-3, num_iters=400)
  np.testing.assert_allclose(r.numpy(), core.hard_rank(theta, "DESCENDING").numpy(),
                             atol=0.05)


@pytest.mark.parametrize("f64", [False, True], ids=["f32", "f64"])
def test_allpairs_baseline_converges_to_hard_ranks(f64):
  theta = torch.tensor(THETA, dtype=torch.float64 if f64 else torch.float32)
  r = baselines.allpairs_rank(theta, temperature=1e-3)
  np.testing.assert_allclose(r.numpy(), core.hard_rank(theta, "DESCENDING").numpy(),
                             atol=1e-3)


def test_not_exported_by_the_core():
  """As ``repro.core`` does not export the baselines, neither does the
  port's ``core``."""
  import repro.core as jcore
  for name in ("allpairs_rank", "ot_rank", "ot_sort", "ot_rank_and_sort"):
    assert not hasattr(jcore, name)
    assert not hasattr(core, name)
