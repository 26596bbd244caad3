"""Paper Figure 4 (left/center): top-k classification loss quality.

Counterpart of the reference's ``benchmarks/bench_topk.py``, on the same
numpy draws in the same order: a 2-layer MLP (32 -> 64 -> classes, ReLU)
on a synthetic cluster-classification task (10 and 100 classes, 40
points a class, 80% for training), trained for 150 full-batch steps at lr
0.05 with the cross-entropy baseline, the soft top-k losses (Q and E, k 1,
eps 0.1) and the all-pairs baseline (tau 0.1); top-1 accuracy on the held
out 20% (``test_acc=``).  The paper's claim: the soft top-k losses reach
accuracy comparable to cross-entropy at far lower cost than O(n^2)
methods.

The reference draws the initial weights with ``jax.random.PRNGKey(0)``,
which numpy cannot reproduce: ``mlp_init`` draws them from a seeded
``torch.Generator`` on the CPU (so the card and the CPU start alike), and
``mlp_from_numpy`` takes given weights (the reference's, in the tests).

Each soft top-k step makes one isotonic solve on the (320, 10) or
(3200, 100) sigmoid scores: ``pav_l2`` for Q, ``pav_kl`` for E.  The
all-pairs baseline is O(n^2) PyTorch ops (a (rows, n, n) tensor a step),
cross-entropy PyTorch's.  ``us_per_call`` is the host wall of a training
over its steps, as the reference's (which includes ``jax.jit``'s
compile): nothing is warmed up.

  PYTHONPATH=src python -m repro_torch.experiments.bench_topk [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import soft_topk_loss, topk_accuracy
from repro_torch.core.baselines import allpairs_rank
from repro_torch.examples import add_device_arg, device_of
from repro_torch.experiments import clock, emit

STEPS = 150
DIM = 32
HID = 64
LR = 0.05
CLASSES = (10, 100)
KINDS = ("cross_entropy", "soft_topk_q", "soft_topk_e", "allpairs")
INIT_SEED = 0


def make_data(rng: np.random.Generator, n_classes: int, n_per: int = 40,
              device="cpu") -> tuple[torch.Tensor, torch.Tensor]:
  """(x (n_classes * n_per, DIM) f32, y int64), shuffled: the reference's
  draws in its order (the centers, each class's points, the
  permutation)."""
  centers = rng.normal(size=(n_classes, DIM)) * 2.0
  xs, ys = [], []
  for c in range(n_classes):
    xs.append(centers[c] + rng.normal(size=(n_per, DIM)))
    ys.append(np.full(n_per, c))
  x = np.concatenate(xs).astype(np.float32)
  y = np.concatenate(ys).astype(np.int64)
  perm = rng.permutation(len(x))
  return (torch.from_numpy(x[perm]).to(device),
          torch.from_numpy(y[perm]).to(device))


def mlp_init(n_classes: int, device="cpu") -> dict[str, torch.Tensor]:
  """The reference's scales (w1 ~ N(0, 1/DIM), w2 ~ N(0, 1/HID)), drawn
  from a ``torch.Generator`` seeded ``INIT_SEED`` on the CPU."""
  gen = torch.Generator().manual_seed(INIT_SEED)
  w1 = torch.randn((DIM, HID), generator=gen) * (1 / np.sqrt(DIM))
  w2 = torch.randn((HID, n_classes), generator=gen) * (1 / np.sqrt(HID))
  return mlp_from_numpy(w1.numpy(), w2.numpy(), device)


def mlp_from_numpy(w1: np.ndarray, w2: np.ndarray,
                   device="cpu") -> dict[str, torch.Tensor]:
  return {"w1": torch.tensor(np.asarray(w1), dtype=torch.float32,
                             device=device),
          "w2": torch.tensor(np.asarray(w2), dtype=torch.float32,
                             device=device)}


def mlp_apply(p: dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
  return torch.relu(x @ p["w1"]) @ p["w2"]


def losses() -> dict:
  """The reference's four losses of (scores, labels)."""

  def xent(theta, y):
    return -torch.mean(torch.gather(torch.log_softmax(theta, -1), 1,
                                    y[:, None]))

  def soft_q(theta, y):
    return soft_topk_loss(theta, y, 1, 1e-1, "l2")

  def soft_e(theta, y):
    return soft_topk_loss(theta, y, 1, 1e-1, "kl")

  def allpairs(theta, y):
    r = allpairs_rank(torch.sigmoid(theta), 0.1)
    r_true = torch.gather(r, 1, y[:, None])[:, 0]
    return torch.mean(torch.relu(r_true - 1))

  return {"cross_entropy": xent, "soft_topk_q": soft_q,
          "soft_topk_e": soft_e, "allpairs": allpairs}


def train(loss_fn, params: dict[str, torch.Tensor], x: torch.Tensor,
          y: torch.Tensor, steps: int = STEPS) -> dict[str, torch.Tensor]:
  """``steps`` full-batch gradient steps at lr 0.05 on both weights."""
  p = dict(params)
  for _ in range(steps):
    leaves = [p[k].detach().requires_grad_(True) for k in ("w1", "w2")]
    q = dict(zip(("w1", "w2"), leaves))
    grads = torch.autograd.grad(loss_fn(mlp_apply(q, x), y), leaves)
    p = {k: (a - LR * g).detach() for (k, a), g in zip(q.items(), grads)}
  return p


def run(device: torch.device, kinds=KINDS) -> list[dict]:
  """The reference's rows, of the losses ``kinds`` only (the data are drawn
  alike whichever they are)."""
  rows: list[dict] = []
  rng = np.random.default_rng(0)
  for n_classes in CLASSES:
    x, y = make_data(rng, n_classes, device=device)
    n_train = int(len(x) * 0.8)
    xtr, ytr, xte, yte = x[:n_train], y[:n_train], x[n_train:], y[n_train:]
    for name, loss_fn in losses().items():
      if name not in kinds:
        continue
      params = mlp_init(n_classes, device=device)
      t0 = clock(device)
      params = train(loss_fn, params, xtr, ytr, STEPS)
      dt = (clock(device) - t0) / STEPS * 1e6
      acc = float(topk_accuracy(mlp_apply(params, xte), yte, 1))
      emit(rows, f"fig4_topk/{name}/classes={n_classes}", dt,
           f"test_acc={acc:.3f}", params, test_acc=acc, steps=STEPS,
           n_test=len(xte))
  return rows


def main(argv=None) -> list[dict]:
  ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  add_device_arg(ap)
  return run(device_of(ap.parse_args(argv).device))


if __name__ == "__main__":
  main()
