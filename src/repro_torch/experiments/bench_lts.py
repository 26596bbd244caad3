"""Paper §6.4 / Figures 6-7: robust regression via soft least trimmed squares.

Counterpart of the reference's ``benchmarks/bench_lts.py``, on the same
numpy draws in the same order.

Fig. 6: the soft-LTS objective interpolates between hard LTS (eps -> 0)
and least squares (eps -> inf); eps is swept and the objective's distance
to each endpoint reported (``objective=``, ``frac_to_LS=``).

Fig. 7 proxy: R^2 on clean test data against the training labels'
outlier fraction, for least squares (ridge), Huber, hard LTS and soft LTS
(Q), on synthetic linear data with injected label noise (y += N(0, 5 std));
300 full-batch gradient steps each.  The paper's claim: (soft) LTS
degrades far more gracefully than least squares as the fraction grows.

Each hard or soft LTS step makes one isotonic solve (``pav_l2`` on the
card) on the (1, 512) residuals, and so does each Fig. 6 evaluation.
``us_per_call`` is the host wall of a fit over its steps, as the
reference's (which includes ``jax.jit``'s compile): nothing is warmed up.

  PYTHONPATH=src python -m repro_torch.experiments.bench_lts [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import soft_lts_loss
from repro_torch.examples import add_device_arg, device_of
from repro_torch.experiments import clock, emit

STEPS = 300
D = 16
N = 512
KINDS = ("least_squares", "huber", "hard_lts", "soft_lts")
FIG6_EPS = (1e-4, 1e-2, 1.0, 1e2, 1e5)
OUTLIER_FRACS = (0.0, 0.1, 0.2, 0.3, 0.4)
TRIM = 0.3
HARD_EPS = 1e-7


def make_data(rng: np.random.Generator, outlier_frac: float, device="cpu"):
  """(x (N, D), y (N,), xte (256, D), yte (256,)) f32 tensors and w_true:
  the reference's draws in its order (w_true, x, the label noise, the
  outliers' indices, their noise, xte)."""
  w_true = rng.normal(size=D)
  x = rng.normal(size=(N, D)).astype(np.float32)
  y = x @ w_true + 0.1 * rng.normal(size=N)
  n_out = int(outlier_frac * N)
  idx = rng.choice(N, n_out, replace=False)
  y[idx] += rng.normal(size=n_out) * 5 * np.std(y)
  xte = rng.normal(size=(256, D)).astype(np.float32)
  yte = xte @ w_true

  def f32(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(device)

  return f32(x), f32(y), f32(xte), f32(yte), w_true


def loss_fn(loss_kind: str, x: torch.Tensor, y: torch.Tensor,
            eps: float = 1e-2, trim: float = TRIM):
  """The reference's four losses of ``w`` (D,): least squares with a 1e-4
  ridge, Huber (t = 1.345), hard LTS (soft LTS at eps 1e-7) and soft LTS,
  each trimming ``int(trim * N)`` residuals."""
  k = int(trim * x.shape[0])

  def loss(w):
    res = 0.5 * (y - x @ w) ** 2
    if loss_kind == "least_squares":
      return torch.mean(res) + 1e-4 * torch.sum(w ** 2)
    if loss_kind == "huber":
      e = y - x @ w
      t = 1.345
      return torch.mean(torch.where(torch.abs(e) < t, 0.5 * e ** 2,
                                    t * (torch.abs(e) - 0.5 * t)))
    if loss_kind == "hard_lts":
      return soft_lts_loss(res, k, HARD_EPS)
    if loss_kind == "soft_lts":
      return torch.mean(soft_lts_loss(res, k, eps))
    raise ValueError(loss_kind)

  return loss


def fit(loss_kind: str, x: torch.Tensor, y: torch.Tensor, eps: float = 1e-2,
        trim: float = TRIM, lr: float = 0.05,
        steps: int = STEPS) -> torch.Tensor:
  """``steps`` full-batch gradient steps on ``w`` from zeros."""
  loss = loss_fn(loss_kind, x, y, eps, trim)
  w = torch.zeros(D, dtype=torch.float32, device=x.device)
  for _ in range(steps):
    w = w.detach().requires_grad_(True)
    (g,) = torch.autograd.grad(loss(w), w)
    w = (w - lr * g).detach()
  return w


def r2(w: torch.Tensor, xte: torch.Tensor, yte: torch.Tensor) -> float:
  pred = xte @ w
  ss_res = torch.sum((yte - pred) ** 2)
  ss_tot = torch.sum((yte - torch.mean(yte)) ** 2)
  return float(1 - ss_res / ss_tot)


def fig6(x: torch.Tensor, y: torch.Tensor) -> list[tuple[float, float,
                                                          float]]:
  """(eps, objective, frac_to_LS) at each eps of the sweep, at w = 0."""
  res = 0.5 * (y - x @ torch.zeros(D, dtype=x.dtype, device=x.device)) ** 2
  k = int(TRIM * N)
  hard = float(soft_lts_loss(res, k, HARD_EPS))
  ls = float(torch.mean(res))
  out = []
  for eps in FIG6_EPS:
    v = float(torch.mean(soft_lts_loss(res, k, eps)))
    out.append((eps, v, (v - hard) / max(ls - hard, 1e-9)))
  return out


def run(device: torch.device) -> list[dict]:
  rows: list[dict] = []
  rng = np.random.default_rng(0)
  x, y, _, _, _ = make_data(rng, 0.2, device)
  for eps, v, frac in fig6(x, y):
    emit(rows, f"fig6_interpolation/eps={eps:g}", 0.0,
         f"objective={v:.4f},frac_to_LS={frac:.3f}", objective=v,
         frac_to_LS=frac)
  for frac in OUTLIER_FRACS:
    x, y, xte, yte, _ = make_data(rng, frac, device)
    for kind in KINDS:
      t0 = clock(device)
      w = fit(kind, x, y, steps=STEPS)
      dt = (clock(device) - t0) / STEPS * 1e6
      score = r2(w, xte, yte)
      emit(rows, f"fig7_robust_regression/{kind}/outliers={frac}", dt,
           f"r2={score:.3f}", {"w": w}, r2=score, steps=STEPS)
  return rows


def main(argv=None) -> list[dict]:
  ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  add_device_arg(ap)
  return run(device_of(ap.parse_args(argv).device))


if __name__ == "__main__":
  main()
