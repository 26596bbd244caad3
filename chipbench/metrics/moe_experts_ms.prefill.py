"""Device ms a traced request of the kernels launched inside
repro_moe_experts (the routed experts' three products and SiLU, every
layer)."""

from chipbench import readers

LAYER = "models/moe.py::moe_apply"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "ttft_p95_ms"


def read(facts: dict, trace):
  return readers.range_ms(facts, trace, "prefill", "repro_moe_experts")
