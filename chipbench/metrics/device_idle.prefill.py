"""Share of the traced requests' time in which no operation ran on the card."""

from chipbench import readers

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "ttft_p95_ms"


def read(facts: dict, trace):
  return readers.idle_pct(facts, trace, "prefill")
