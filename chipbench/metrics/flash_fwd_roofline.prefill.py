"""The attention kernel's least time at each traced request's length over its
device time, every launch."""

from chipbench import readers

LAYER = "kernels/flash_attention.py -> csrc/flash_attention.cu"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "ttft_p95_ms"


def read(facts: dict, trace):
  return readers.flash_roofline_pct(facts, trace, "prefill")
