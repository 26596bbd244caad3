"""Share of the traced decode steps in which no operation ran on the card."""

from chipbench import readers

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "decode_tokens_per_s"


def read(facts: dict, trace):
  return readers.idle_pct(facts, trace, "decode")
