"""Device ms a traced decode step of the kernels launched inside
repro_moe_experts (the routed experts' three products and SiLU, every
layer)."""

from chipbench import readers

LAYER = "models/moe.py::moe_apply"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "decode_tokens_per_s"


def read(facts: dict, trace):
  return readers.range_ms(facts, trace, "decode", "repro_moe_experts")
