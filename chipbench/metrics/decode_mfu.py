"""The window's share of the decode steps' roofline: each step's least time
(the larger of its model FLOPs over the bf16 peak and the bytes it must move
over HBM's) summed, over the window's seconds."""

from chipbench import readers

LAYER = "launch/steps.py::make_decode_step"
UNIT = "%"
SOURCE = "host_clock"
MOVES = "decode_tokens_per_s"


def read(facts: dict, trace):
  return readers.peak_share_pct(facts, "decode")
