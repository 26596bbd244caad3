"""The plain reference: its isotonic fit against a brute-force one, its
projection against the port's operators, and whole runs of each cell at
smoke size on the CPU, where the program (its plain kernels, in f32) and
the reference have to agree to rounding."""

from __future__ import annotations

import itertools

import pytest
import torch

from chipbench.reference import model as M
from chipbench.reference import softsort as S
from chipbench.tests import tiny


def pav_loop(y):
  """Pool adjacent violators for a non-increasing fit, one row, f64."""
  blocks = []
  for v in y.tolist():
    blocks.append([v, 1])
    while len(blocks) > 1 and blocks[-2][0] / blocks[-2][1] < \
        blocks[-1][0] / blocks[-1][1]:
      s, n = blocks.pop()
      blocks[-1][0] += s
      blocks[-1][1] += n
  return torch.tensor(list(itertools.chain.from_iterable(
      [s / n] * n for s, n in blocks)), dtype=torch.float64)


@pytest.mark.parametrize("n", [1, 2, 7, 64])
def test_isotonic_against_pav(n):
  g = torch.Generator().manual_seed(n)
  y = torch.randn((5, n), generator=g, dtype=torch.float64)
  y[0] = torch.round(y[0])                         # ties
  got = S.isotonic_nonincreasing(y)
  for row, want in zip(got, map(pav_loop, y)):
    torch.testing.assert_close(row, want, rtol=0, atol=1e-12)


def test_isotonic_gradient_is_block_mean():
  y = torch.tensor([1.0, 3.0, 2.5, -1.0], dtype=torch.float64,
                   requires_grad=True)
  v = S.isotonic_nonincreasing(y)
  torch.testing.assert_close(v.detach(), torch.tensor(
      [6.5 / 3, 6.5 / 3, 6.5 / 3, -1.0], dtype=torch.float64))
  (g,) = torch.autograd.grad(v[0], y)
  torch.testing.assert_close(g, torch.tensor([1 / 3, 1 / 3, 1 / 3, 0.0],
                                             dtype=torch.float64))


def test_soft_topk_and_sort_against_the_port():
  from repro_torch.core import operators as ops
  from repro_torch.core.losses import soft_trimmed_token_loss
  g = torch.Generator().manual_seed(0)
  logits = torch.randn((16, 8), generator=g, dtype=torch.float64,
                       requires_grad=True)
  mine = S.soft_topk_mask(logits, 2, 1.0)
  port = ops.soft_topk_mask(logits, 2, 1.0)
  torch.testing.assert_close(mine, port)
  w = torch.randn((16, 8), generator=g, dtype=torch.float64)
  ga, = torch.autograd.grad((mine * w).sum(), logits)
  gb, = torch.autograd.grad((port * w).sum(), logits)
  torch.testing.assert_close(ga, gb)
  losses = torch.rand(64, generator=g, dtype=torch.float64) * 3
  for eps in (0.01, 1.0, 100.0):
    torch.testing.assert_close(S.soft_trimmed_mean(losses, 0.1, eps),
                               soft_trimmed_token_loss(losses, 0.1, eps))


@pytest.mark.parametrize("cell", list(tiny.CELLS))
def test_program_and_reference_agree_in_f32(cell):
  env = tiny.env(cell, seed=7)
  line = tiny.run(env)
  assert line["correct"]
  for name, c in line["checks"].items():
    assert c["value"] < 1e-4, (name, c)


def test_precision_rounds_products_to_fp8():
  x = torch.linspace(-3, 3, 101)
  q = M.FP8.q(x)
  assert 0 < float((q - x).abs().max()) < 0.2
  assert torch.equal(M.F32.q(x), x)
