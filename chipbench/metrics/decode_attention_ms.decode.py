"""Device ms a traced decode step of the kernels launched inside
repro_decode_attention (each layer's attention over its full-length
cache)."""

from chipbench import readers

LAYER = "models/layers.py::decode_attention"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "decode_tokens_per_s"


def read(facts: dict, trace):
  return readers.range_ms(facts, trace, "decode", "repro_decode_attention")
