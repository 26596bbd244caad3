"""Port of ``repro.kernels.pav_scan``: the divide-and-conquer PAV.

The plain ``pav_l2_scan`` / ``pav_kl_scan`` of the port against the
reference's (jitted) and against the port's stack machine, on the same
numpy inputs: ties and constant rows, n a power of two and not, n = 1, an
adversarial row that pools across the top level, and f64.  Then the
``"scan"`` backend through ``soft_rank`` / ``soft_sort`` with their Lemma 2
gradients, against the reference's ``"scan"``.  The l2 and kl kernels of
``csrc/pav_scan.cu`` run only on the card (``requires_cuda``).

Tolerances: 1e-5 * (1 + max|input|) in f32, 1e-10 in f64
(``test_torch_common``).  The stack machine pools ties (``<=``) and the
divide-and-conquer merge does not (``<``), and the two add in different
orders, so they agree to the last bits and in the number of blocks that
the backward reads from equal adjacent outputs
(``segment_vjp.block_starts``).  The kernels keep the plain version's
merge order and are held to it bit for bit (kl: the same logaddexp
formula as ``torch.logaddexp`` on the card).
"""

from __future__ import annotations

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_common import (  # noqa: E402
    CONTRACT_F64,
    as_torch,
    assert_close,
    assert_vjp_parity,
    composed_ref,  # noqa: F401
    cuda_device,  # noqa: F401
    rows_with_ties,
)

import repro.core as jcore  # noqa: E402
from repro.kernels import pav_scan as jscan  # noqa: E402
import repro_torch.core as core  # noqa: E402
from repro_torch.kernels import pav, pav_scan, segment_vjp  # noqa: E402

SEED = 53


def two_ramps(rows: int, n: int) -> np.ndarray:
  """Each row: two strictly decreasing halves, the right one above the
  left.  Every level below the top is already solved; the top level's
  pool absorbs every block, one per side and step."""
  half = n // 2
  left = np.linspace(0.0, -1.0, half)
  right = np.linspace(2.0, 1.0, n - half)
  return np.tile(np.concatenate([left, right]), (rows, 1))


def _inputs(case: str, rng) -> tuple[np.ndarray, np.ndarray]:
  if case == "ties":
    return rows_with_ties(rng, 4, 9), rows_with_ties(rng, 4, 9)
  if case == "pow2":
    return rng.normal(size=(3, 16)), rng.normal(size=(3, 16))
  if case == "n1":
    return rng.normal(size=(3, 1)), rng.normal(size=(3, 1))
  if case == "long":
    return rng.normal(size=(2, 300)), rng.normal(size=(2, 300))
  if case == "two_ramps":
    return two_ramps(2, 37), np.zeros((2, 37))
  raise ValueError(case)


CASES = ["ties", "pow2", "n1", "long", "two_ramps"]


def _blocks(v: torch.Tensor) -> int:
  return int(segment_vjp.block_starts(v).sum())


@pytest.mark.parametrize("case", CASES)
def test_scan_l2_matches_reference_and_stack(case):
  y, _ = _inputs(case, np.random.default_rng(SEED))
  want = jax.jit(jscan.pav_l2_scan)(jnp.asarray(y, jnp.float32))
  got = pav_scan.pav_l2_scan(as_torch(y))
  assert_close(got, want, y)
  stack = pav.pav_l2_stack(as_torch(y))
  assert_close(got, stack, y)
  assert _blocks(got) == _blocks(stack)


@pytest.mark.parametrize("case", CASES)
def test_scan_kl_matches_reference_and_stack(case):
  s, w = _inputs(case, np.random.default_rng(SEED))
  want = jax.jit(jscan.pav_kl_scan)(jnp.asarray(s, jnp.float32),
                                    jnp.asarray(w, jnp.float32))
  got = pav_scan.pav_kl_scan(as_torch(s), as_torch(w))
  assert_close(got, want, s, w)
  stack = pav.pav_kl_stack(as_torch(s), as_torch(w))
  assert_close(got, stack, s, w)
  assert _blocks(got) == _blocks(stack)


def test_two_ramps_pool_into_one_block():
  """The adversarial row: one block, the row mean, for both algebras."""
  y = two_ramps(1, 64)
  got = pav_scan.pav_l2_scan(as_torch(y, torch.float64))
  np.testing.assert_allclose(got.numpy(), np.full((1, 64), y.mean()),
                             rtol=0, atol=1e-12)
  s = two_ramps(1, 64)
  got_kl = pav_scan.pav_kl_scan(as_torch(s, torch.float64),
                                torch.zeros((1, 64), dtype=torch.float64))
  assert _blocks(got_kl) == 1


@pytest.mark.parametrize("case", ["ties", "long", "two_ramps"])
def test_scan_f64_matches_reference(case):
  s, w = _inputs(case, np.random.default_rng(SEED))
  with jax.enable_x64(True):
    want_l2 = jax.jit(jscan.pav_l2_scan)(jnp.asarray(s, jnp.float64))
    want_kl = jax.jit(jscan.pav_kl_scan)(jnp.asarray(s, jnp.float64),
                                         jnp.asarray(w, jnp.float64))
  got_l2 = pav_scan.pav_l2_scan(as_torch(s, torch.float64))
  got_kl = pav_scan.pav_kl_scan(as_torch(s, torch.float64),
                                as_torch(w, torch.float64))
  assert got_l2.dtype == got_kl.dtype == torch.float64
  assert_close(got_l2, want_l2, s, contract=CONTRACT_F64)
  assert_close(got_kl, want_kl, s, w, contract=CONTRACT_F64)


@pytest.mark.usefixtures("composed_ref")
@pytest.mark.parametrize("op", ["soft_sort", "soft_rank"])
@pytest.mark.parametrize("reg", ["l2", "kl"])
def test_scan_backend_through_operators(op, reg):
  """The "scan" backend forward, with the shared Lemma 2 backward, against
  the reference's "scan" backend."""
  rng = np.random.default_rng(SEED)
  x = rows_with_ties(rng, 4, 10)
  kwargs = dict(regularization_strength=0.5, regularization=reg)
  assert_vjp_parity(
      functools.partial(getattr(jcore, op), impl="scan", **kwargs),
      functools.partial(getattr(core, op), impl="scan", **kwargs),
      (x,), rng.normal(size=x.shape))


def test_scan_backend_is_registered_and_not_the_builtin_choice(monkeypatch):
  from repro_torch.kernels import dispatch

  monkeypatch.delenv("REPRO_TORCH_BACKEND", raising=False)
  cpu = torch.device("cpu")
  for reg in ("l2", "kl"):
    assert "scan" in dispatch.registered_backends("isotonic", reg)
    assert dispatch.resolve("isotonic", reg, "scan", cpu) == "scan"
    assert dispatch.resolve("isotonic", reg, None, cpu) == "stack"
  monkeypatch.setenv("REPRO_TORCH_BACKEND", "scan")
  assert dispatch.resolve("isotonic", "l2", None, cpu) == "scan"


@pytest.mark.requires_cuda
@pytest.mark.parametrize("shape,kind", [
    ((8, 257), "ties"), ((3, 1), "random"), ((4, 16384), "random"),
    ((3, 40000), "random"), ((1, 70001), "two_ramps"),
    ((2, 20000), "two_ramps")])
def test_cuda_l2_kernel_matches_plain_version(shape, kind, cuda_device):
  """On the card: the kernel against the plain divide-and-conquer version
  on the same f32 inputs, bit for bit (same merge order), and against the
  stack machine within the contract, with the same number of blocks.
  Rows above 16384 run the levels above one tile in device memory."""
  rng = np.random.default_rng(SEED)
  y = (rows_with_ties(rng, *shape) if kind == "ties"
       else two_ramps(*shape) if kind == "two_ramps"
       else rng.normal(size=shape))
  yt = as_torch(y)
  before = pav.LAUNCHES["pav_l2"]
  got = pav.pav_l2(yt.to(cuda_device))
  torch.cuda.synchronize()
  assert pav.LAUNCHES["pav_l2"] == before + 1
  want = pav_scan.pav_l2_scan(yt.to(cuda_device)).cpu()
  np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
  if shape[1] <= 5000:   # the stack machine takes a Python step a column
    stack = pav.pav_l2_stack(yt.to(cuda_device)).cpu()
    assert_close(got.cpu(), stack, y)
    assert _blocks(got) == _blocks(stack)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("shape,kind", [
    ((8, 257), "ties"), ((3, 1), "random"), ((4, 16384), "random"),
    ((3, 40000), "random"), ((1, 70001), "two_ramps"),
    ((2, 20000), "two_ramps")])
def test_cuda_kl_kernel_matches_plain_version(shape, kind, cuda_device):
  """On the card: the kl kernel against the plain divide-and-conquer
  version on the same f32 inputs, bit for bit (same merges in the same
  order, logaddexp by torch's formula), and against the stack machine
  within the contract, with the same number of blocks.  Rows above 16384
  run the levels above one tile in device memory."""
  rng = np.random.default_rng(SEED)
  if kind == "ties":
    s, w = rows_with_ties(rng, *shape), rows_with_ties(rng, *shape)
  elif kind == "two_ramps":
    s, w = two_ramps(*shape), np.zeros(shape)
  else:
    s, w = rng.normal(size=shape), rng.normal(size=shape)
  st, wt = as_torch(s).to(cuda_device), as_torch(w).to(cuda_device)
  before = pav.LAUNCHES["pav_kl"]
  got = pav.pav_kl(st, wt)
  torch.cuda.synchronize()
  assert pav.LAUNCHES["pav_kl"] == before + 1
  want = pav_scan.pav_kl_scan(st, wt).cpu()
  np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
  if shape[1] <= 5000:   # the stack machine takes a Python step a column
    stack = pav.pav_kl_stack(st, wt).cpu()
    assert_close(got.cpu(), stack, s, w)
    assert _blocks(got) == _blocks(stack)


def test_row_slices_cover_the_batch_in_grid_sized_launches():
  assert pav.row_slices(0) == []
  assert pav.row_slices(5) == [(0, 5)]
  assert pav.row_slices(65535) == [(0, 65535)]
  assert pav.row_slices(70000) == [(0, 65535), (65535, 70000)]
  assert pav.row_slices(3 * 65535 + 1)[-1] == (3 * 65535, 3 * 65535 + 1)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("kname", ["pav_l2", "pav_kl"])
def test_cuda_kernels_take_more_rows_than_the_grid(kname, cuda_device):
  """70000 rows (the grid takes 65535): two launches, and bit for bit
  the plain divide and conquer on every row."""
  rng = np.random.default_rng(SEED)
  args = [as_torch(rng.normal(size=(70000, 64))).to(cuda_device)
          for _ in range(1 if kname == "pav_l2" else 2)]
  before = pav.LAUNCHES[kname]
  got = getattr(pav, kname)(*args)
  torch.cuda.synchronize()
  assert pav.LAUNCHES[kname] == before + 2
  want = getattr(pav_scan, f"{kname}_scan")(*args)
  np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
