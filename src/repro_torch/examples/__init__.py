"""The reference's example programs (``examples/*.py``) as the port's own.

Each runs as ``python -m repro_torch.examples.<name>`` with the
reference's arguments and defaults, on the card unless ``--device cpu``
is given (where there is no card it raises, as the server and the trainer
do; the CPU takes every size: these are CPU demos in the reference), and
has ``main(argv) -> dict`` returning what it prints.

* ``quickstart``: the operators on the paper's Figure-1 example.
* ``label_ranking``: the Spearman label ranking of paper §6.3, with and
  without the projection (Table 1's "No projection" column).
* ``robust_lm_training``: the soft least-trimmed-squares token loss of
  paper §6.4 against label noise, lifted to LM pretraining.
* ``moe_soft_router``: the softmax top-k router against the paper's soft
  top-k router (loss, expert-load coefficient of variation), then greedy
  generation from the soft-routed model.
"""

from __future__ import annotations

import argparse

import torch


def add_device_arg(ap: argparse.ArgumentParser) -> None:
  ap.add_argument("--device", default="cuda",
                  help="cuda (the default; raises where there is no card) "
                  "or cpu")


def device_of(name: str) -> torch.device:
  """The device of ``--device``: the card, raising where there is none, or
  the CPU at any size."""
  device = torch.device(name)
  if device.type not in ("cpu", "cuda"):
    raise ValueError(f"unknown device {name!r}")
  if device.type == "cuda" and not torch.cuda.is_available():
    raise RuntimeError("CUDA is not available: the example runs on the card "
                       "(pass --device cpu to run it on the CPU)")
  return device


def synchronize(device: torch.device) -> None:
  if device.type == "cuda":
    torch.cuda.synchronize(device)
