"""The serving pad contract of the port: bucket-padded ops equal the port's
unpadded operators bit for bit, per backend.

``repro_torch.serving.ops`` pads every request up to its shape bucket so
that the pads sort strictly below the real entries and never pool with
them; the sliced-back result is then bitwise equal to the unpadded call on
the same backend (``stack``, ``scan`` and ``minimax`` on the CPU; ``cuda``
on the card, ``requires_cuda``).  The backend is pinned in every call:
plans may route the padded and the unpadded shape differently, and
different backends agree only within the contract.

Tolerances: vector ops bitwise (``torch.equal``); the scalar losses
(Spearman, LTS), masked reductions whose summation order differs between
n and the bucket, within 1e-5 relative (1e-6 absolute).  Against the
reference's padded ops (``repro.serving.ops``, run with
``REPRO_PROJECTION=composed``) on the same rows: 1e-5 * (1 + max(|input|,
|want|)) (``test_torch_common``).
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from test_torch_common import (  # noqa: E402,F401
    assert_close,
    composed_ref,
    cuda_device,
)

from repro.serving import ops as jops  # noqa: E402
from repro_torch.core import (  # noqa: E402
    projection_permutahedron,
    soft_lts_loss,
    soft_rank,
    soft_sort,
    soft_spearman_loss,
    soft_topk_mask,
)
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.serving.ops import SERVING_OPS, bound_op, margin  # noqa: E402

BACKENDS = ["stack", "scan", "minimax"]
REGS = ["l2", "kl"]
BUCKET = 16
NS = (1, 5, 11, BUCKET)
VECTOR_OPS = ["soft_sort/desc", "soft_sort/asc", "soft_rank/desc",
              "soft_rank/asc", "soft_topk", "projection"]


def _rng(*key) -> np.random.Generator:
  """A generator seeded by the test's own parameters, so every case sees
  the same data in any order."""
  return np.random.default_rng([sum(map(ord, str(k))) for k in key])


def _row(values, bucket=BUCKET, fill=0.0):
  n = values.shape[-1]
  row = np.full((1, bucket), fill, np.float32)
  row[0, :n] = values
  return row


def _padded_call(key, impl, values, eps, extra=None, device="cpu"):
  """The padded op on one padded row; the real prefix (or the scalar)."""
  n = values.shape[-1]
  args = [torch.from_numpy(_row(values)), torch.tensor([n]),
          torch.tensor([eps], dtype=torch.float32)]
  if extra is not None:
    args.append(torch.from_numpy(np.asarray(extra)))
  args = [a.to(device) for a in args]
  out = bound_op(key, impl)(*args).cpu()
  return out[0, :n] if out.dim() == 2 else out[0]


def _unpadded(op, reg, impl, v, eps, rng, device="cpu"):
  """(padded op key, extra, unpadded port result) for one vector op."""
  x = torch.from_numpy(v).to(device)
  name, _, direction = op.partition("/")
  dirn = "ASCENDING" if direction == "asc" else "DESCENDING"
  if name == "soft_sort":
    return f"{name}/{reg}/{direction}", None, soft_sort(
        x, eps, reg, dirn, impl=impl)
  if name == "soft_rank":
    return f"{name}/{reg}/{direction}", None, soft_rank(
        x, eps, reg, dirn, impl=impl)
  if name == "soft_topk":
    k = max(1, v.shape[-1] // 3)
    return f"soft_topk/{reg}", np.array([k], np.int32), soft_topk_mask(
        x, k, eps, reg, impl=impl)
  w = rng.standard_normal(v.shape[-1]).astype(np.float32)
  if reg == "kl":
    w = np.abs(w) + 0.1
  return f"projection/{reg}", _row(w), projection_permutahedron(
      x, torch.from_numpy(w).to(device), reg, impl)


# eps values at which multiplying by the reciprocal rounds otherwise than
# dividing (2.9, 1.2897...; not 0.7), which the operators must not do.
EPS = (0.7, 2.9, 1.2897623193945442)


def _check_vector_op(op, reg, impl, device="cpu"):
  rng = _rng(op, reg, impl)
  for n in NS:
    for kind, eps in (("random", EPS[0]), ("ties", EPS[1]),
                      ("random", EPS[2])):
      v = rng.standard_normal(n).astype(np.float32) * 3
      if kind == "ties":
        v = np.round(v) / 2
      key, extra, want = _unpadded(op, reg, impl, v, eps, rng, device)
      got = _padded_call(key, impl, v, eps, extra, device)
      assert torch.equal(got, want.cpu()), (key, n, kind,
                                            (got - want.cpu()).abs().max())


@pytest.mark.parametrize("impl", BACKENDS)
@pytest.mark.parametrize("reg", REGS)
@pytest.mark.parametrize("op", VECTOR_OPS)
def test_padded_vector_op_is_bitwise(op, reg, impl):
  _check_vector_op(op, reg, impl)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("reg", REGS)
@pytest.mark.parametrize("op", VECTOR_OPS)
def test_padded_vector_op_is_bitwise_on_the_card(op, reg, cuda_device):
  _check_vector_op(op, reg, "cuda", cuda_device)


@pytest.mark.parametrize("impl", BACKENDS)
@pytest.mark.parametrize("reg", REGS)
def test_padded_scalar_losses_match_the_losses(impl, reg, monkeypatch):
  """LTS and Spearman (ascending, the loss's default) against the port's
  losses with the backend pinned by ``REPRO_TORCH_BACKEND``."""
  monkeypatch.setenv(dispatch.ENV_VAR, impl)
  rng = _rng("scalar", impl, reg)
  v = rng.standard_normal(9).astype(np.float32) ** 2
  got = _padded_call(f"lts/{reg}", impl, v, 0.8, np.array([3], np.int32))
  want = soft_lts_loss(torch.from_numpy(v), 3, 0.8, reg)
  np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-6)
  v = rng.standard_normal(7).astype(np.float32)
  target = rng.permutation(7).astype(np.float32) + 1.0
  got = _padded_call(f"spearman/{reg}/asc", impl, v, 0.6, _row(target))
  want = soft_spearman_loss(torch.from_numpy(v), torch.from_numpy(target),
                            0.6, reg, direction="ASCENDING")
  np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("impl", BACKENDS)
@pytest.mark.parametrize("eps", [1e-3, 1.0, 1e3])
def test_padded_extreme_eps_is_bitwise(impl, eps):
  """eps near the hard-sort and the constant-collapse limits."""
  v = _rng("eps", impl, eps).standard_normal(6).astype(np.float32)
  for reg in REGS:
    got = _padded_call(f"soft_sort/{reg}/desc", impl, v, eps)
    want = soft_sort(torch.from_numpy(v), eps, reg, impl=impl)
    assert torch.equal(got, want)


def test_pad_lane_inputs_are_ignored():
  v = _rng("lanes").standard_normal(5).astype(np.float32)
  outs = []
  for fill in (0.0, 1e30, -1e30, np.nan):
    out = bound_op("soft_rank/l2/desc", "stack")(
        torch.from_numpy(_row(v, fill=fill)), torch.tensor([5]),
        torch.tensor([0.5]))
    outs.append(out[0, :5])
  for o in outs[1:]:
    assert torch.equal(outs[0], o)


def test_padded_batch_rows_are_independent():
  """Rows with different true_n and eps in one batch equal per-row calls."""
  rng = _rng("rows")
  ns, epss = [2, 7, BUCKET], [0.3, 1.0, 2.5]
  rows = [rng.standard_normal(n).astype(np.float32) for n in ns]
  batch = torch.from_numpy(np.concatenate([_row(v) for v in rows]))
  out = bound_op("soft_sort/kl/desc", "scan")(
      batch, torch.tensor(ns), torch.tensor(epss))
  for i, (v, n, eps) in enumerate(zip(rows, ns, epss)):
    want = soft_sort(torch.from_numpy(v), eps, "kl", impl="scan")
    assert torch.equal(out[i, :n], want)
    assert torch.all(out[i, n:] == 0)


def test_margin_clears_f32_exp_underflow():
  for n in (1, 64, 4096):
    assert margin(n) > 104.0
    assert float(torch.exp(torch.tensor(-margin(n)))) == 0.0


@pytest.mark.parametrize("key", sorted(SERVING_OPS))
def test_padded_ops_match_the_reference(key, composed_ref):
  """Every serving op of the port against the reference's padded op on the
  same batch (two rows of different lengths, the ``scan`` backend in
  both), within the contract."""
  rng = _rng("ref", key)
  spec = SERVING_OPS[key]
  ns = np.array([5, 12], np.int32)
  values = rng.standard_normal((2, BUCKET)).astype(np.float32)
  eps = np.array([0.5, 1.5], np.float32)
  extras = []
  for name, _, _ in spec.extras:
    if name in ("k", "trim"):
      extras.append(np.array([2, 3], np.int32))
    elif name == "target":
      extras.append(np.stack([np.concatenate(
          [rng.permutation(int(n)) + 1.0, np.zeros(BUCKET - n)])
          for n in ns]).astype(np.float32))
    else:
      extras.append(np.abs(rng.standard_normal((2, BUCKET))).astype(
          np.float32) + 0.1)
  want = np.asarray(jops.bound_op(key, impl="scan")(
      jnp.asarray(values), jnp.asarray(ns), jnp.asarray(eps),
      *map(jnp.asarray, extras)))
  got = bound_op(key, "scan")(
      torch.from_numpy(values), torch.from_numpy(ns), torch.from_numpy(eps),
      *map(torch.from_numpy, extras))
  assert_close(got, want, values, want)
