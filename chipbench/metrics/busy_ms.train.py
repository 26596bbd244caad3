"""Device ms a traced training step in which an operation ran on the card:
the step's work on the device, which the host's pace does not change."""

from chipbench import readers

LAYER = "device"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "train_tokens_per_s"


def read(facts: dict, trace):
  return readers.busy_ms(facts, trace, "train")
