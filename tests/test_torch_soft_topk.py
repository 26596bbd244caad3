"""Port of the soft top-k router gate: oracle, plain version, CUDA wrapper.

The port's plain gates (sort -> PAV stack machine -> un-sort) against the
reference's fused Pallas kernel run in interpret mode and against its
minimax oracle ``soft_topk_gates_ref``, on the same numpy logits, with
ties.  Tolerance: 1e-5 * (1 + max|reference|) (``test_torch_common``).
The kernel itself runs only on the card (``requires_cuda``).
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
from repro_torch.kernels import ops, ref, soft_topk  # noqa: E402

rng = np.random.default_rng(23)


def _logits(rows: int, e: int) -> np.ndarray:
  """Random rows, a row on a grid of 0.5 (ties), a constant row."""
  x = rng.normal(size=(rows, e)) * 2
  x[1] = np.round(x[1] * 2) / 2
  x[2] = 0.75
  return x


@pytest.mark.parametrize("e", [8, 64, 100])
@pytest.mark.parametrize("k", [1, 2, 6])
def test_plain_gates_match_pallas_kernel_and_oracle(e, k):
  x = _logits(6, e)
  for eps in (0.5, 1.0):
    want_kernel = jsoft_topk.soft_topk_gates(jnp.asarray(x, jnp.float32), k,
                                             eps, interpret=True)
    want_ref = jref.soft_topk_gates_ref(jnp.asarray(x, jnp.float32), k, eps)
    got = soft_topk.soft_topk_gates(as_torch(x), k, eps)
    assert got.dtype == torch.float32
    assert_close(got, want_kernel, want_kernel)
    assert_close(got, want_ref, want_ref)
    g = got.numpy()
    assert g.min() >= 0.0 and g.max() <= 1.0 + 1e-6
    np.testing.assert_allclose(g.sum(-1), k, rtol=0, atol=1e-5 * e)


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


@pytest.mark.requires_cuda
@pytest.mark.parametrize("eps", [1.0, 0.3])
@pytest.mark.parametrize("shape", [(4096, 64), (8, 64), (33, 100), (5, 8)])
def test_cuda_kernel_matches_plain_version(shape, eps, cuda_device):
  """On the card: the kernel against the plain version on the same
  logits; the same scaling by the f32 reciprocal of eps (also for eps =
  0.3, not a power of two) and the same PAV arithmetic, so the same
  floats."""
  x = _logits(*shape)
  xd = as_torch(x).to(cuda_device)
  before = soft_topk.LAUNCHES["soft_topk_gates"]
  got = soft_topk.soft_topk_gates(xd, 6, eps)
  torch.cuda.synchronize()
  assert soft_topk.LAUNCHES["soft_topk_gates"] == before + 1
  want = soft_topk.soft_topk_gates_plain(xd, 6, eps)
  np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
