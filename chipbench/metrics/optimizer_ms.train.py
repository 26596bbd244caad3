"""Device ms a traced step of the kernels launched inside
repro_optimizer_update."""

from chipbench import readers

LAYER = "optim/adamw.py"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "train_tokens_per_s"


def read(facts: dict, trace):
  return readers.range_ms(facts, trace, "train", "repro_optimizer_update")
