"""Model FLOPs of the window's steps over (the window's seconds x the bf16
peak)."""

from chipbench import readers

LAYER = "launch/steps.py::make_train_step"
UNIT = "%"
SOURCE = "host_clock"
MOVES = "train_tokens_per_s"


def read(facts: dict, trace):
  return readers.peak_share_pct(facts, "train")
