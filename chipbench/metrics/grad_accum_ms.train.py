"""Device ms a traced training step of the kernels launched inside
repro_grad_accumulate (each microbatch's gradients added into the f32
accumulators, and the final mean cast back)."""

from chipbench import readers

LAYER = "launch/steps.py::make_train_step"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "train_tokens_per_s"


def read(facts: dict, trace):
  return readers.range_ms(facts, trace, "train", "repro_grad_accumulate")
