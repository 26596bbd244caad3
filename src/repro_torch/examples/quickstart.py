"""Quickstart: fast differentiable sorting and ranking in 2 minutes.

Counterpart of the reference's ``examples/quickstart.py``:

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

The reference draws its two random inputs with ``jax.random``; here they
come from ``np.random.default_rng(0)`` (``inputs``), and ``run`` takes them
as arguments, so that a test can hand both programs the same ones.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core import (soft_quantile, soft_rank, soft_sort,
                              soft_topk_mask, spearman_correlation)
from repro_torch.examples import add_device_arg, device_of, synchronize


def inputs(seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
  """(x (999,), batch (4, 10)): the soft median's sample and the batch."""
  rng = np.random.default_rng(seed)
  return (rng.standard_normal(999, dtype=np.float32),
          rng.standard_normal((4, 10), dtype=np.float32))


def run(x: np.ndarray, batch: np.ndarray, device: torch.device,
        verbose: bool = True) -> dict:
  """Every value the reference prints, as lists of floats (ranks' shape as
  a list of ints), computed on ``device``."""
  say = print if verbose else (lambda *a: None)
  t = lambda a: torch.tensor(a, dtype=torch.float32, device=device)
  out = {}

  def show(key: str, label: str, value: torch.Tensor) -> None:
    out[key] = value.detach().cpu().tolist()
    say(label, out[key])

  # --- the paper's Figure-1 example ---------------------------------------
  theta = t([2.9, 0.1, 1.2])
  show("theta", "theta         =", theta)
  show("soft_rank_eps1", "soft_rank eps=1 (Q):", soft_rank(theta, 1.0))
  show("soft_rank_eps10", "soft_rank eps=10   :", soft_rank(theta, 10.0))
  show("soft_sort_eps0.1", "soft_sort eps=0.1  :", soft_sort(theta, 0.1))

  # --- everything is differentiable (exact O(n) Jacobian products) --------
  th = theta.clone().requires_grad_(True)
  loss = torch.sum(soft_rank(th, 10.0) * t([1.0, 0.0, 0.0]))
  show("grad_rank0", "d rank_0 / d theta =", torch.autograd.grad(loss, th)[0])

  # --- entropic regularization (paper's E variant) ------------------------
  show("soft_rank_kl", "soft_rank KL       :",
       soft_rank(theta, 1.0, regularization="kl"))

  # --- differentiable top-k and quantiles ---------------------------------
  scores = t([3.0, 1.0, 2.0, 0.0, -1.0])
  show("topk_mask", "soft top-2 mask    :", soft_topk_mask(scores, 2, 0.5))
  show("soft_median", "soft median        :", soft_quantile(t(x), 0.5, 0.01))

  # --- batched on the last axis -------------------------------------------
  ranks = soft_rank(t(batch), 0.1)
  out["ranks_shape"] = list(ranks.shape)
  say("batched ranks shape:", tuple(ranks.shape))
  show("spearman", "spearman(batch[0], batch[0]) =",
       spearman_correlation(ranks[0], ranks[0]))
  return out


def main(argv=None) -> dict:
  ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  add_device_arg(ap)
  args = ap.parse_args(argv)
  device = device_of(args.device)
  t0 = time.perf_counter()
  out = run(*inputs(), device)
  synchronize(device)
  out["seconds"] = time.perf_counter() - t0
  return out


if __name__ == "__main__":
  main()
