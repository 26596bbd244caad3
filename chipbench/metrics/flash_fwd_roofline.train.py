"""The attention kernel's least time at the training shape over its device
time, every launch of the traced steps (forward and remat's recompute)."""

from chipbench import readers

LAYER = "kernels/flash_attention.py -> csrc/flash_attention.cu"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_tokens_per_s"


def read(facts: dict, trace):
  return readers.flash_roofline_pct(facts, trace, "train")
