"""Device ms a traced training step of the kernels launched inside
repro_attention_bwd (the attention backward, f32 PyTorch ops, every
layer and microbatch)."""

from chipbench import readers

LAYER = "kernels/flash_attention.py::flash_attention_bwd"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "train_tokens_per_s"


def read(facts: dict, trace):
  return readers.range_ms(facts, trace, "train", "repro_attention_bwd")
