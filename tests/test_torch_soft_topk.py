"""Port of the soft top-k router gate: oracle, plain version, CUDA wrapper.

The port's plain gates (stable argsort -> the one pool at k -> scatter
back) against the reference's fused Pallas kernel run in interpret mode
and against its minimax oracle ``soft_topk_gates_ref``, on the same numpy
logits (seeded by their shape), with ties and a constant row, for E from
1 to 128 and k from 0 to E.  Tolerance: 1e-5 * (1 + max|reference|)
(``test_torch_common``); where the reference's own rounding follows the
projection's input z = logits / eps rather than its output,
1e-5 * (1 + max|z|), the contract relative to that input: at k = 0 and
k = E (every gate 0 or 1; the Pallas kernel's interval means, differences
of a cumsum, leave ~2e-5 of rounding) and at eps = 1e-2 (z reaches a few
hundred, where an f32 ulp is about 3e-5, so a gate s - fl(s - w) may also
leave [0, 1] by two ulps of z).  The plain gates are also held against
the earlier formulation (sort -> ``pav_l2_stack`` -> un-sort), and the
pool-at-k fit against the divide-and-conquer PAV of ``pav_scan``: bit for
bit against its merge of the two solved segments [0, k) | [k, E), within
the contract and with the same blocks against ``pav_l2_scan`` on the
whole row.  The kernel itself runs only on the card (``requires_cuda``).
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from test_torch_common import (  # noqa: E402
    as_torch,
    assert_close,
    cuda_device,  # noqa: F401
)

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import soft_topk as jsoft_topk  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    ops,
    pav,
    pav_scan,
    ref,
    segment_vjp,
    soft_topk,
)

def _logits(rows: int, e: int) -> np.ndarray:
  """Random rows, a row on a grid of 0.5 (ties), a constant row; seeded by
  the shape, so a test's data do not depend on which tests ran before."""
  x = np.random.default_rng([23, rows, e]).normal(size=(rows, e)) * 2
  x[1] = np.round(x[1] * 2) / 2
  x[2] = 0.75
  return x


# (k, e): every k in {0, 1, 2, 6, E} up to E, for E from 1 to 128.
GATE_CASES = [(k, e) for e in (1, 8, 64, 100, 128)
              for k in sorted({0, 1, 2, 6, e}) if k <= e]
EPS = (0.5, 1.0, 1e-2)


def _slack(x: np.ndarray, eps: float) -> float:
  """How far f32 rounding may put a gate outside [0, 1]: a gate is
  s - fl(s - w), rounded at the magnitude of z = logits / eps, so two ulps
  of max|z| at eps = 1e-2; 1e-6 where |z| stays near 10 or below."""
  if eps >= 0.5:
    return 1e-6
  return float(2 * np.spacing(np.float32(np.abs(x / eps).max() + 1)))


def _scale(x: np.ndarray, k: int, eps: float, want) -> np.ndarray:
  """What the tolerance is relative to: the gates themselves, or at k = 0,
  k = E and eps = 1e-2 the projection's input z = logits / eps (module
  note)."""
  e = x.shape[1]
  return x / eps if k in (0, e) or eps < 0.1 else np.asarray(want)


@pytest.mark.parametrize("k,e", GATE_CASES)
def test_plain_gates_match_pallas_kernel_and_oracle(k, e):
  x = _logits(6, e)
  for eps in EPS:
    want_kernel = jsoft_topk.soft_topk_gates(jnp.asarray(x, jnp.float32), k,
                                             eps, interpret=True)
    want_ref = jref.soft_topk_gates_ref(jnp.asarray(x, jnp.float32), k, eps)
    got = soft_topk.soft_topk_gates(as_torch(x), k, eps)
    assert got.dtype == torch.float32
    assert_close(got, want_kernel, _scale(x, k, eps, want_kernel))
    assert_close(got, want_ref, _scale(x, k, eps, want_ref))
    g, slack = got.numpy(), _slack(x, eps)
    assert g.min() >= (0.0 if eps >= 0.5 else -slack)
    assert g.max() <= 1.0 + slack
    np.testing.assert_allclose(g.sum(-1), k, rtol=0,
                               atol=max(1e-5, slack) * e)


def _gates_by_stack(logits: torch.Tensor, k: int, eps: float):
  """The earlier formulation: sort -> the PAV stack machine on the whole
  row -> un-sort."""
  z = logits / eps
  e = z.shape[1]
  w = (torch.arange(e) < k).to(z.dtype)
  sigma = torch.argsort(-z, dim=-1, stable=True)
  s = torch.gather(z, 1, sigma)
  return torch.empty_like(s).scatter_(1, sigma, s - pav.pav_l2_stack(s - w))


@pytest.mark.parametrize("k,e", GATE_CASES)
def test_plain_gates_match_sort_stack_machine_unsort(k, e):
  x = _logits(6, e)
  for eps in EPS:
    got = soft_topk.soft_topk_gates_plain(as_torch(x), k, eps)
    want = _gates_by_stack(as_torch(x), k, eps)
    assert_close(got, want, _scale(x, k, eps, want))


def _sorted_y(x: np.ndarray, k: int, eps: float) -> torch.Tensor:
  z = as_torch(x) / eps
  s = torch.sort(z, dim=-1, descending=True, stable=True).values
  return s - (torch.arange(z.shape[1]) < k).to(z.dtype)


def _merge_of_two_segments(y: torch.Tensor, k: int) -> torch.Tensor:
  """pav_scan's divide and conquer on [+inf.., y[:k]] | [y[k:], -inf..],
  each half 2^m long: every level below the top leaves both halves as they
  are (non-increasing singletons, strict <), and the top level is the one
  merge of [0, k) and [k, E), in _merge_level's order."""
  t, e = y.shape
  half = pav_scan._next_pow2(max(k, e - k))
  inf = torch.full((t, half), float("inf"))
  row = torch.cat([inf[:, :half - k], y, -inf[:, :half - (e - k)]], dim=1)
  out = pav_scan._dac_pav(
      (row, torch.ones_like(row)),
      merge=lambda a, c: (a[0] + c[0], a[1] + c[1]),
      block_value=lambda r: r[0] / torch.clamp(r[1], min=1e-30))
  return out[:, half - k:half - k + e]


@pytest.mark.parametrize("k,e", GATE_CASES)
def test_pool_at_k_is_the_divide_and_conquer_merge(k, e):
  x = _logits(6, e)
  for eps in EPS:
    y = _sorted_y(x, k, eps)
    got = soft_topk.pool_at_k(y, k)
    if 0 < k < e:
      np.testing.assert_array_equal(got.numpy(),
                                    _merge_of_two_segments(y, k).numpy())
    else:
      np.testing.assert_array_equal(got.numpy(), y.numpy())
    want = pav_scan.pav_l2_scan(y)
    assert_close(got, want, y)
    assert (int(segment_vjp.block_starts(got).sum())
            == int(segment_vjp.block_starts(want).sum()))


@pytest.mark.parametrize("e", [8, 100])
def test_port_oracle_matches_reference_oracle(e):
  x = _logits(5, e)
  want = jref.soft_topk_gates_ref(jnp.asarray(x, jnp.float32), 3, 0.5)
  assert_close(ref.soft_topk_gates_ref(as_torch(x), 3, 0.5), want, want)


def test_plain_gates_keep_the_input_dtype():
  x = _logits(4, 16)
  got = soft_topk.soft_topk_gates(as_torch(x, torch.float64), 2, 1.0)
  assert got.dtype == torch.float64
  want = ref.soft_topk_gates_ref(as_torch(x), 2, 1.0)
  assert_close(got, want, want)


def test_gates_reject_bad_arguments_and_count_no_launch_on_cpu():
  before = ops.all_launches()
  x = torch.randn(3, 10)
  soft_topk.soft_topk_gates(x, 2)
  for bad, exc in (((x[0], 2), ValueError), ((x, 11), ValueError),
                   ((torch.randn(2, 129), 2), ValueError),
                   ((torch.ones(2, 4, dtype=torch.int32), 1), TypeError)):
    with pytest.raises(exc):
      soft_topk.soft_topk_gates(*bad)
  assert ops.all_launches() == before


def _gates_refuse_autograd(device) -> None:
  """Logits that require grad raise while grad is enabled; detached,
  under no_grad, or not requiring grad, they run."""
  x = torch.randn(8, 64, device=device, requires_grad=True)
  before = ops.all_launches()
  with pytest.raises(RuntimeError, match="forward only"):
    soft_topk.soft_topk_gates(x, 6)
  assert ops.all_launches() == before
  with torch.no_grad():
    soft_topk.soft_topk_gates(x, 6)
  soft_topk.soft_topk_gates(x.detach(), 6)


def test_gates_raise_under_autograd_on_cpu():
  _gates_refuse_autograd(torch.device("cpu"))


@pytest.mark.requires_cuda
def test_gates_raise_under_autograd_on_the_card(cuda_device):
  _gates_refuse_autograd(cuda_device)
  torch.cuda.synchronize()


@pytest.mark.requires_cuda
@pytest.mark.parametrize("eps", [1.0, 0.3, 1e-2])
@pytest.mark.parametrize("shape", [(4096, 64), (8, 64), (33, 100), (5, 8)])
def test_cuda_kernel_matches_plain_version(shape, eps, cuda_device):
  """On the card: the kernel against the plain version on the same
  logits; the same scaling by the f32 reciprocal of eps (also for eps =
  0.3, not a power of two) and the same pool arithmetic, so the same
  floats."""
  x = _logits(*shape)
  xd = as_torch(x).to(cuda_device)
  before = soft_topk.LAUNCHES["soft_topk_gates"]
  got = soft_topk.soft_topk_gates(xd, 6, eps)
  torch.cuda.synchronize()
  assert soft_topk.LAUNCHES["soft_topk_gates"] == before + 1
  want = soft_topk.soft_topk_gates_plain(xd, 6, eps)
  np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.requires_cuda
@pytest.mark.parametrize("kind", ["random", "ties", "constant"])
@pytest.mark.parametrize("rows", [4096, 8])
def test_cuda_kernel_matches_plain_version_at_grok_router(rows, kind,
                                                          cuda_device):
  """On the card, bit for bit, at grok-1's router: E = 8 (the kernel's one
  register a lane branch, E <= 32), k = 2, eps 1.0, at a prefill layer's
  4096 tokens and a decode step's 8, on random logits, on ties (a grid of
  0.5) and on constant rows."""
  x = np.random.default_rng([29, rows]).normal(size=(rows, 8))
  if kind == "ties":
    x = np.round(x * 2) / 2
  elif kind == "constant":
    x[:] = 0.75
  xd = as_torch(x).to(cuda_device)
  before = soft_topk.LAUNCHES["soft_topk_gates"]
  got = soft_topk.soft_topk_gates(xd, 2, 1.0)
  torch.cuda.synchronize()
  assert soft_topk.LAUNCHES["soft_topk_gates"] == before + 1
  want = soft_topk.soft_topk_gates_plain(xd, 2, 1.0)
  np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
  np.testing.assert_allclose(got.sum(-1).cpu().numpy(), 2.0, rtol=0,
                             atol=1e-5)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("k,e", GATE_CASES)
def test_cuda_kernel_matches_plain_version_at_every_k(k, e, cuda_device):
  """On the card, bit for bit, for every (k, E) of the CPU cases, at the
  three eps values (k = 0 and k = E: no pool; E = 1; E past 32 and 64)."""
  x = as_torch(_logits(6, e)).to(cuda_device)
  for eps in EPS:
    got = soft_topk.soft_topk_gates(x, k, eps)
    want = soft_topk.soft_topk_gates_plain(x, k, eps)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
