"""Device ms a traced step of the kernels launched inside the
repro_projection_*, repro_isotonic_* and repro_soft_lts_loss ranges (the
router's projection and PAV, forward and backward, and the soft-LTS loss's
forward), each kernel once."""

from chipbench import readers

LAYER = "core/projection.py -> kernels/dispatch.py -> pav_scan.cu"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "train_tokens_per_s"


def read(facts: dict, trace):
  return readers.range_ms(facts, trace, "train", "repro_projection_", "repro_isotonic_", "repro_soft_lts_loss")
