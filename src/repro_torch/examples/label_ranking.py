"""Label ranking via the differentiable Spearman coefficient (paper §6.3).

Counterpart of the reference's ``examples/label_ranking.py``: trains a
linear model on synthetic label-ranking data with the soft-rank Spearman
loss, then ablates the soft-rank layer ("No projection" column of the
paper's Table 1) — the projection consistently improves held-out rho.

  PYTHONPATH=src python -m repro_torch.examples.label_ranking [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core import hard_rank, soft_spearman_loss, spearman_correlation
from repro_torch.examples import add_device_arg, device_of, synchronize


def make_dataset(rng: np.random.Generator, d: int = 20, n_labels: int = 10,
                 n: int = 512, noise: float = 0.75,
                 device="cpu") -> tuple[torch.Tensor, torch.Tensor]:
  """(x (n, d) f32, ranks (n, n_labels) f32 1..n_labels ascending): the
  reference's draws in its order."""
  w = rng.normal(size=(d, n_labels))
  x = rng.normal(size=(n, d)).astype(np.float32)
  scores = x @ w + noise * rng.normal(size=(n, n_labels))
  ranks = hard_rank(torch.from_numpy(scores).to(torch.float32), "ASCENDING")
  return (torch.from_numpy(x).to(device),
          ranks.to(device=device, dtype=torch.float32))


def train(x: torch.Tensor, ranks: torch.Tensor, use_projection: bool,
          steps: int = 300, lr: float = 0.02) -> torch.Tensor:
  """Gradient descent on w (d, n_labels) from zeros: the soft Spearman
  loss (eps 1) with the projection, half the mean squared error of the raw
  scores against the ranks without it."""
  w = torch.zeros((x.shape[1], ranks.shape[1]), dtype=torch.float32,
                  device=x.device)

  def loss(w):
    theta = x @ w
    if use_projection:
      return soft_spearman_loss(theta, ranks, 1.0)
    return 0.5 * torch.mean(torch.sum((theta - ranks) ** 2, -1))

  for _ in range(steps):
    w = w.requires_grad_(True)
    (g,) = torch.autograd.grad(loss(w), w)
    w = (w - lr * g).detach()
  return w


def held_out_rho(x: torch.Tensor, ranks: torch.Tensor,
                 w: torch.Tensor) -> float:
  pred = hard_rank(x @ w, "ASCENDING")
  return float(torch.mean(spearman_correlation(pred, ranks)))


def main(argv=None) -> dict:
  ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  ap.add_argument("--steps", type=int, default=300)
  add_device_arg(ap)
  args = ap.parse_args(argv)
  device = device_of(args.device)
  t0 = time.perf_counter()
  x, ranks = make_dataset(np.random.default_rng(0), device=device)
  n_tr = int(0.8 * len(x))
  out = {}
  for use_proj in (True, False):
    w = train(x[:n_tr], ranks[:n_tr], use_proj, steps=args.steps)
    rho = held_out_rho(x[n_tr:], ranks[n_tr:], w)
    name = "soft-rank layer (r_Q)" if use_proj else "no projection"
    print(f"{name:24s} held-out Spearman rho = {rho:.4f}")
    out["rho_projection" if use_proj else "rho_no_projection"] = rho
  synchronize(device)
  out["steps"] = args.steps
  out["seconds"] = time.perf_counter() - t0
  return out


if __name__ == "__main__":
  main()
