"""Paper §6.3 / Table 1: label ranking via soft Spearman correlation.

Counterpart of the reference's ``benchmarks/bench_label_ranking.py``, on
the same numpy draws in the same order.  Synthetic label-ranking datasets
(linear ground truth plus observation noise, at noise 0.25 and 1.0): a
linear model trained with the soft-rank Spearman loss (r_Q, r_E, and the
appendix's r~_E, ``kl_direct``) against the "no projection" ablation
(the squared loss on the raw scores).  Metric: Spearman's rho on held-out
data (``spearman_rho=``).  The paper's claim: the soft-rank layer improves
rho on most datasets.

Each step makes one isotonic solve on the (204, 8) scores: ``pav_l2`` for
r_Q, ``pav_kl`` for r_E and r~_E, none for the ablation.
``us_per_call`` is the host wall of a training over its steps, as the
reference's (which includes ``jax.jit``'s compile): nothing is warmed up.

  PYTHONPATH=src python -m repro_torch.experiments.bench_label_ranking \
      [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import (
    hard_rank, soft_rank_kl_direct, soft_spearman_loss, spearman_correlation)
from repro_torch.examples import add_device_arg, device_of
from repro_torch.experiments import clock, emit

STEPS = 200
LR = 0.02
KINDS = ("soft_rank_q", "soft_rank_e", "kl_direct", "no_projection")
NOISES = (0.25, 1.0)


def make_dataset(rng: np.random.Generator, d: int = 16, n_labels: int = 8,
                 n: int = 256, noise: float = 0.5, device="cpu"
                 ) -> tuple[torch.Tensor, torch.Tensor]:
  """(x (n, d) f32, ranks (n, n_labels) f32, 1..n_labels ascending): the
  reference's draws in its order."""
  w = rng.normal(size=(d, n_labels))
  x = rng.normal(size=(n, d)).astype(np.float32)
  scores = x @ w + noise * rng.normal(size=(n, n_labels))
  ranks = hard_rank(torch.from_numpy(scores).to(torch.float32), "ASCENDING")
  return torch.from_numpy(x).to(device), ranks.to(device)


def loss_fn(loss_kind: str, x: torch.Tensor, ranks: torch.Tensor):
  """The reference's four losses of ``w`` (d, n_labels)."""

  def loss(w):
    theta = x @ w
    if loss_kind == "no_projection":
      return 0.5 * torch.mean(torch.sum((theta - ranks) ** 2, -1))
    if loss_kind == "soft_rank_q":
      return soft_spearman_loss(theta, ranks, 1.0, "l2")
    if loss_kind == "soft_rank_e":
      return soft_spearman_loss(theta, ranks, 1.0, "kl")
    if loss_kind == "kl_direct":
      r = soft_rank_kl_direct(theta, 1.0)
      return 0.5 * torch.mean(torch.sum((r - ranks) ** 2, -1))
    raise ValueError(loss_kind)

  return loss


def train(loss_kind: str, x: torch.Tensor, ranks: torch.Tensor,
          steps: int = STEPS) -> torch.Tensor:
  """``steps`` full-batch gradient steps at lr 0.02 on w from zeros."""
  loss = loss_fn(loss_kind, x, ranks)
  w = torch.zeros((x.shape[1], ranks.shape[1]), dtype=torch.float32,
                  device=x.device)
  for _ in range(steps):
    w = w.requires_grad_(True)
    (g,) = torch.autograd.grad(loss(w), w)
    w = (w - LR * g).detach()
  return w


def held_out_rho(x: torch.Tensor, ranks: torch.Tensor,
                 w: torch.Tensor) -> float:
  pred = hard_rank(x @ w, "ASCENDING")
  return float(torch.mean(spearman_correlation(pred, ranks)))


def run(device: torch.device) -> list[dict]:
  rows: list[dict] = []
  rng = np.random.default_rng(0)
  for noise in NOISES:
    x, ranks = make_dataset(rng, noise=noise, device=device)
    n_train = int(0.8 * x.shape[0])
    xtr, rtr = x[:n_train], ranks[:n_train]
    xte, rte = x[n_train:], ranks[n_train:]
    for kind in KINDS:
      t0 = clock(device)
      w = train(kind, xtr, rtr, STEPS)
      dt = (clock(device) - t0) / STEPS * 1e6
      rho = held_out_rho(xte, rte, w)
      emit(rows, f"table1_label_ranking/{kind}/noise={noise}", dt,
           f"spearman_rho={rho:.3f}", {"w": w}, spearman_rho=rho,
           steps=STEPS)
  return rows


def main(argv=None) -> list[dict]:
  ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  add_device_arg(ap)
  return run(device_of(ap.parse_args(argv).device))


if __name__ == "__main__":
  main()
