"""The share of the MoE layers' capacity slots that a token took, over the
traced segment: 100 x moe_slots_filled / moe_slots, the program's counters,
which count on the device only while a profiler records.  None where the
program counted no slots."""

LAYER = "models/moe.py::moe_apply"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "ttft_p95_ms"


def read(facts: dict, trace):
  if facts["kind"] != "prefill" or trace is None:
    return None
  from repro_torch.obs import metrics
  counts = metrics.counters("moe_slots")
  slots = counts.get("moe_slots", 0)
  if slots <= 0:
    return None
  return 100.0 * counts.get("moe_slots_filled", 0) / slots
