"""Port of the isotonic kernels: oracles, plain stack machine, CUDA wrappers.

``repro_torch.kernels.ref`` against ``repro.kernels.ref``, the plain
``pav_*_stack`` against the reference's Pallas kernels run in interpret
mode (and against ``pav_*_lax`` in f64), and the CUDA wrappers' contract
on the CPU: they raise, and the dispatch never routes a CPU tensor to them.
Tolerances: see ``test_torch_common``.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_common import (  # noqa: E402
    CONTRACT_BF16,
    CONTRACT_F64,
    as_torch,
    assert_close,
    cuda_device,  # noqa: F401
    rows_with_ties,
)

from repro.kernels import dispatch as jdispatch  # noqa: E402
from repro.kernels import pav as jpav  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import _build, dispatch, pav, ref  # noqa: E402

rng = np.random.default_rng(11)

SHAPES = [(4, 9), (3, 1)]   # a batch with ties and a constant row; n = 1


@pytest.mark.parametrize("shape", SHAPES)
def test_ref_l2_matches_reference(shape):
  y = rows_with_ties(rng, *shape)
  want = jax.jit(jref.pav_l2_ref)(jnp.asarray(y, jnp.float32))
  assert_close(ref.pav_l2_ref(as_torch(y)), want, y)


@pytest.mark.parametrize("shape", SHAPES)
def test_ref_kl_matches_reference(shape):
  s, w = rows_with_ties(rng, *shape), rng.normal(size=shape)
  want = jax.jit(jref.pav_kl_ref)(jnp.asarray(s, jnp.float32),
                                  jnp.asarray(w, jnp.float32))
  assert_close(ref.pav_kl_ref(as_torch(s), as_torch(w)), want, s, w)


@pytest.mark.parametrize("shape", SHAPES)
def test_stack_l2_matches_pallas_interpret(shape):
  y = rows_with_ties(rng, *shape)
  want = jpav.pav_l2(jnp.asarray(y, jnp.float32), interpret=True)
  got = pav.pav_l2_stack(as_torch(y))
  # Same stack machine, same f32 arithmetic in the same order.
  np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shape", SHAPES)
def test_stack_kl_matches_pallas_interpret(shape):
  s, w = rows_with_ties(rng, *shape), rows_with_ties(rng, *shape)
  want = jpav.pav_kl(jnp.asarray(s, jnp.float32), jnp.asarray(w, jnp.float32),
                     interpret=True)
  assert_close(pav.pav_kl_stack(as_torch(s), as_torch(w)), want, s, w)


def test_stack_f64_matches_lax():
  y, w = rows_with_ties(rng, 4, 9), rng.normal(size=(4, 9))
  with jax.enable_x64(True):
    want_l2 = jpav.pav_l2_lax(jnp.asarray(y, jnp.float64))
    want_kl = jpav.pav_kl_lax(jnp.asarray(y, jnp.float64),
                              jnp.asarray(w, jnp.float64))
  got_l2 = pav.pav_l2_stack(as_torch(y, torch.float64))
  got_kl = pav.pav_kl_stack(as_torch(y, torch.float64),
                            as_torch(w, torch.float64))
  assert got_l2.dtype == got_kl.dtype == torch.float64
  assert_close(got_l2, want_l2, y, contract=CONTRACT_F64)
  assert_close(got_kl, want_kl, y, w, contract=CONTRACT_F64)


def test_stack_matches_minimax_oracle_on_soft_rank_range():
  """z = -theta/eps at eps = 1e-2 against rho: the soft-rank solver input."""
  theta = rng.normal(size=(3, 16))
  s = np.sort(-theta / 1e-2, axis=-1)[:, ::-1].copy()
  w = np.broadcast_to(np.arange(16, 0, -1.0), s.shape).copy()
  assert_close(pav.pav_l2_stack(as_torch(s - w)),
               ref.pav_l2_ref(as_torch(s - w)), s, w)
  assert_close(pav.pav_kl_stack(as_torch(s), as_torch(w)),
               ref.pav_kl_ref(as_torch(s), as_torch(w)), s, w)


@pytest.mark.parametrize("reg", ["l2", "kl"])
def test_dispatch_bf16_in_and_out(reg):
  """bf16 is promoted once in dispatch and demoted on return, as in the
  reference; held against the reference's bf16 result at bf16 precision."""
  x = rng.normal(size=(3, 11))
  w = np.sort(rng.normal(size=(11,)))[::-1].copy()
  xb = jnp.asarray(x, jnp.bfloat16)
  wb = jnp.broadcast_to(jnp.asarray(w, jnp.bfloat16), xb.shape)
  args_j = (xb,) if reg == "l2" else (xb, wb)
  want = jdispatch.dispatch("isotonic", reg, "minimax", *args_j)
  xt = as_torch(x, torch.bfloat16)
  args_t = (xt,) if reg == "l2" else (
      xt, as_torch(w, torch.bfloat16).expand(xt.shape))
  got = dispatch.dispatch("isotonic", reg, None, *args_t)
  assert got.dtype == torch.bfloat16
  assert_close(got, np.asarray(want, np.float32), x, contract=CONTRACT_BF16)


def test_cuda_backend_raises_on_cpu_tensor():
  y = torch.randn(2, 5)
  before = dict(pav.LAUNCHES)
  with pytest.raises(ValueError, match="CUDA"):
    pav.pav_l2(y)
  with pytest.raises(ValueError, match="CUDA"):
    pav.pav_kl(y, y)
  with pytest.raises(ValueError, match="CUDA"):
    dispatch.dispatch("isotonic", "l2", "cuda", y)
  assert pav.LAUNCHES == before


def test_build_writes_only_inside_a_checkout(monkeypatch, tmp_path):
  """A package imported from outside a checkout's src/ (an installed copy)
  refuses to build rather than write beside its install prefix."""
  monkeypatch.setattr(_build, "CHECKOUT", tmp_path)
  monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build" / "kernels")
  with pytest.raises(RuntimeError, match="checkout"):
    _build.build_all()
  assert not (tmp_path / "build").exists()


def test_builtin_choice_follows_the_device(monkeypatch):
  monkeypatch.delenv("REPRO_TORCH_BACKEND", raising=False)
  cpu, gpu = torch.device("cpu"), torch.device("cuda", 0)
  for reg in ("l2", "kl"):
    assert dispatch.resolve("isotonic", reg, None, cpu) == "stack"
    assert dispatch.resolve("isotonic", reg, "auto", gpu) == "cuda"
    # n <= 64 stays on the kernel: no minimax routing by size.
    assert dispatch.resolve("isotonic", reg, None, gpu) == "cuda"
    assert dispatch.resolve("isotonic", reg, "minimax", gpu) == "minimax"


def test_env_var_precedence(monkeypatch):
  cpu = torch.device("cpu")
  monkeypatch.setenv("REPRO_TORCH_BACKEND", "minimax")
  assert dispatch.resolve("isotonic", "l2", None, cpu) == "minimax"
  assert dispatch.resolve("isotonic", "l2", "stack", cpu) == "stack"
  monkeypatch.setenv("REPRO_TORCH_BACKEND", "lax")
  with pytest.raises(ValueError, match="REPRO_TORCH_BACKEND"):
    dispatch.resolve("isotonic", "l2", None, cpu)
  with pytest.raises(ValueError, match="no forward backend"):
    dispatch.resolve("isotonic", "l2", "pallas", cpu)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("reg", ["l2", "kl"])
def test_cuda_kernel_matches_plain_version(reg, cuda_device):
  """On the card: kernel against the plain stack machine, same inputs."""
  s, w = rows_with_ties(rng, 8, 257), rows_with_ties(rng, 8, 257)
  if reg == "l2":
    got = pav.pav_l2(as_torch(s - w).to(cuda_device))
    want = pav.pav_l2_stack(as_torch(s - w))
  else:
    got = pav.pav_kl(as_torch(s).to(cuda_device), as_torch(w).to(cuda_device))
    want = pav.pav_kl_stack(as_torch(s), as_torch(w))
  torch.cuda.synchronize()
  assert_close(got.cpu(), want, s, w)
