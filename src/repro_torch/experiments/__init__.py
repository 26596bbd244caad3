"""The paper's quality experiments (the reference's ``benchmarks/``
``bench_lts.py``, ``bench_label_ranking.py``, ``bench_topk.py``) as the
port's own programs.

Each runs as ``python -m repro_torch.experiments.<name>`` on the card
unless ``--device cpu`` is given (where there is no card it raises, as the
example programs do), has ``main(argv) -> list[dict]`` returning its rows,
and prints the reference's CSV rows ``name,us_per_call,derived`` with the
reference's names and derived keys, so that the two outputs can be
diffed.  A returned row also holds its metrics unrounded and, for a
training, its final weights (``BANDS`` says how far two runs may part).
``python -m repro_torch.experiments`` runs the three in the reference's
order (``benchmarks/run.py --only
fig4_topk,table1_label_ranking,fig6_fig7_lts``, without its artifact).

* ``bench_lts``: §6.4 / Figures 6-7, soft least trimmed squares between
  hard LTS and least squares, and R^2 against the outlier fraction.
* ``bench_label_ranking``: §6.3 / Table 1, held-out Spearman's rho of the
  soft Spearman loss against the "no projection" ablation.
* ``bench_topk``: Figure 4 left and center, a 2-layer MLP trained with
  cross-entropy, the soft top-k losses and the all-pairs baseline.

``us_per_call`` is what the reference's is: the host wall over a whole
training loop divided by its steps, the first step (the reference's
``jax.jit`` compile; here the kernels' first launch) included.  On the
card the wall is read after ``torch.cuda.synchronize()``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.examples import synchronize

HEADER = "name,us_per_call,derived"

# How far a row may part between two runs of one experiment (the port's
# and the reference's on the CPU, the card's and the CPU's): Fig. 6's
# objective and frac_to_LS relative to 1 + |the other's|, R^2 and rho
# absolute, accuracy by one test sample, and the final weights relative to
# 1 + max|the other's|.  R^2 and rho saturate or count ranks, so each
# run's weights are its tight check.
BANDS = {"objective": 1e-5, "frac_to_LS": 1e-5, "r2": 1e-4,
         "spearman_rho": 1e-4, "weights": 1e-4}
RELATIVE = ("objective", "frac_to_LS")


def band(metric: str, want: float, n_test: int | None = None) -> float:
  """The largest |got - want| allowed of ``metric`` (``test_acc``: one
  sample of ``n_test``; ``weights``: ``want`` is max|want|)."""
  if metric == "test_acc":
    return 1 / n_test + 1e-6
  scale = 1 + abs(want) if metric in RELATIVE + ("weights",) else 1
  return BANDS[metric] * scale


def weights_apart(got: dict, want: dict) -> tuple[float, float]:
  """(max |got - want| over every weight of a row, its band)."""
  err = max(float(np.max(np.abs(np.asarray(got[k]) - np.asarray(want[k]))))
            for k in want)
  top = max(float(np.max(np.abs(np.asarray(v)))) for v in want.values())
  return err, band("weights", top)


def emit(rows: list[dict], name: str, us_per_call: float, derived: str,
         weights: dict[str, torch.Tensor] | None = None,
         **metrics: float) -> None:
  """Print the reference's CSV row and keep it, with its metrics
  unrounded and its final ``weights`` as numpy, in ``rows``."""
  print(f"{name},{us_per_call:.1f},{derived}")
  row = {"name": name, "us_per_call": us_per_call, "derived": derived,
         **metrics}
  if weights is not None:
    row["weights"] = {k: v.detach().cpu().numpy() for k, v in weights.items()}
  rows.append(row)


def clock(device: torch.device) -> float:
  """The host clock once the device has finished what was queued."""
  synchronize(device)
  return time.perf_counter()
