"""Model FLOPs of the window's prefills over (the window's seconds x the bf16
peak)."""

from chipbench import readers

LAYER = "launch/steps.py::make_prefill_step"
UNIT = "%"
SOURCE = "host_clock"
MOVES = "ttft_p95_ms"


def read(facts: dict, trace):
  return readers.peak_share_pct(facts, "prefill")
