"""Device ms a traced request of the kernels launched inside
repro_moe_dispatch and repro_moe_combine (the one-hot capacity dispatch
mask, the tokens sent to their slots, and the combine back), each kernel
once."""

from chipbench import readers

LAYER = "models/moe.py::moe_apply"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "ttft_p95_ms"


def read(facts: dict, trace):
  return readers.range_ms(facts, trace, "prefill", "repro_moe_dispatch",
                          "repro_moe_combine")
