"""Smoke-size copies of the benchmark's cells, for the CPU tests.

Each keeps its configuration's kind and every switch of its traffic, and
cuts every size (widths included, which the benchmark's own cells never
cut) so that a whole run takes seconds on the CPU with the kernels' plain
versions.  ``env(cell)`` builds the run's inputs as ``chipbench.run`` does
from the files, with the sizes replaced.
"""

from __future__ import annotations

import copy
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT / "src") not in sys.path:
  sys.path.insert(0, str(ROOT / "src"))

from chipbench import run as R  # noqa: E402

MODEL = {
    "deepseek-v2-lite-16b.l4": {
        "layers": 2, "d_model": 64, "heads": 4, "kv_heads": 4,
        "head_dim": 24, "kv_lora_rank": 16, "qk_nope_dim": 16,
        "qk_rope_dim": 8, "v_head_dim": 16, "experts": 8,
        "experts_per_token": 2, "shared_experts": 1, "expert_width": 32,
        "vocab": 256, "group_size": 16},
    "grok-1-314b.l6": {
        "layers": 2, "d_model": 64, "heads": 6, "kv_heads": 2, "head_dim": 16,
        "experts": 4, "experts_per_token": 2, "expert_width": 48,
        "vocab": 256, "group_size": 16},
}
TRAFFIC = {
    "train": {"batch": 4, "seq": 32, "grad_accum": 2, "batches": 8,
              "trace_steps": 1},
    "decode": {"batch": 4, "prompt": 32, "gen": 12, "prefill_chunk": 2,
               "check_steps": 3, "check_prompts": 1, "trace_steps": 2},
    "prefill": {"lengths": 4, "min_len": 16, "max_len": 48, "pool": 4096,
                "check_requests": 3, "check_block": 8, "trace_requests": 2},
}


def env(cell: str, seed: int = 1, dtype: str = "float32") -> R.Env:
  full = R.Env.load(cell, seed, "cpu")
  config = copy.deepcopy(full.config)
  config["model"].update(MODEL[config["name"]], dtype=dtype)
  config["port"]["set"] = {R.PORT_FIELDS[k]: v
                           for k, v in config["model"].items()
                           if k in R.PORT_FIELDS}
  config["port"]["set"]["d_ff"] = config["model"]["expert_width"]
  traffic = copy.deepcopy(full.traffic)
  traffic.update(TRAFFIC[traffic["kind"]])
  return R.Env(full.cell, config, traffic, full.limits, seed, "cpu")


CELLS = ("dsv2l4.train-lts", "grok1l6.decode-32x2k",
         "grok1l6.prefill-1x512-4k")


def run(env: R.Env, seconds: float = 0.3) -> dict:
  """One whole run of ``env`` on the CPU, the look for a card skipped."""
  import time
  return R.run_cell(env, seconds, False, time.perf_counter())
