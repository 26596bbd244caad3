"""Run one cell of the benchmark once and print its result line.

    python -m chipbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cell's cards.  The
cell is an entry of ``BENCHMARK.json``'s ``workloads``; its configuration
is ``chipbench/configs/<config>.json``, its traffic
``chipbench/traffic/<traffic>.json`` driven by
``chipbench/traffic/<kind>.py``, its limits
``chipbench/workloads/<cell>.json``, and each per-layer metric is read by
``chipbench/metrics/<metric>.py``: a new cell, mix or metric is new files
and entries, and this file does not change.

A run builds the seed's weights on the card, warms the cell's shapes
(set-up, ``setup_s``, timed from the start of this process), measures for
``--seconds`` seconds and, with ``--trace 1``, traces a further segment of
the same work.  It then reads the card's peak memory, frees the program's
state and compares what the window's path produced with the plain
reference (``chipbench/reference/``): each number beside its limit goes
to standard error as the last lines, and into the result line under
``checks``.  Last, it checks that no module of JAX or of the JAX package
``repro`` is loaded, and prints the result, JSON, as the last line of
standard output.

It exits 2, printing no result, where CUDA is missing or the card count is
short, and 3 where a forbidden module is loaded.  Build and kernel caches
stay inside the checkout (``build/``).
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "chipbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

# The port's field for each of the configuration file's model sizes.
PORT_FIELDS = {"layers": "num_layers", "d_model": "d_model",
               "heads": "num_heads", "kv_heads": "num_kv_heads",
               "head_dim": "head_dim", "vocab": "vocab_size",
               "experts": "num_experts",
               "experts_per_token": "experts_per_token",
               "shared_experts": "num_shared_experts",
               "expert_width": "moe_d_ff", "kv_lora_rank": "kv_lora_rank",
               "qk_nope_dim": "qk_nope_dim", "qk_rope_dim": "qk_rope_dim",
               "v_head_dim": "v_head_dim", "rope_theta": "rope_theta",
               "logit_softcap": "logit_softcap", "router_eps": "router_eps",
               "capacity_factor": "capacity_factor",
               "group_size": "moe_group_size", "dtype": "dtype"}


def load_json(path: Path) -> dict:
  with open(path) as f:
    return json.load(f)


def load_module(path: Path, name: str):
  spec = importlib.util.spec_from_file_location(name, path)
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  return mod


class Env:
  """One run's inputs: the cell, its configuration, traffic and limits,
  the seed, and the device."""

  def __init__(self, cell: dict, config: dict, traffic: dict, limits: dict,
               seed: int, device):
    import torch
    self.cell, self.config, self.traffic, self.limits = (cell, config,
                                                         traffic, limits)
    self.model = config["model"]
    self.seed = seed
    self.device = torch.device(device)
    self.cuda = self.device.type == "cuda"
    self.marks = [("start", _T0)]

  def mark(self, phase: str) -> None:
    """The end of a phase of set-up (``setup_s`` by phase, on stderr)."""
    self.sync()
    self.marks.append((phase, time.perf_counter()))

  @classmethod
  def load(cls, name: str, seed: int, device) -> "Env":
    bench = load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
      raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    return cls(cell, load_json(BENCH / "configs" / f"{cell['config']}.json"),
               load_json(BENCH / "traffic" / f"{cell['traffic']}.json"),
               load_json(BENCH / "workloads" / f"{name}.json")["limits"],
               seed, device)

  def sync(self) -> None:
    if self.cuda:
      import torch
      torch.cuda.synchronize(self.device)

  def port_config(self, **extra):
    """The program's configuration as the file's ``port`` group sets it
    (its arch and overrides), with ``extra`` fields, checked against the
    file's model sizes."""
    import dataclasses
    from repro_torch.configs.base import get_config
    port = self.config["port"]
    cfg = dataclasses.replace(get_config(port["arch"]), **port["set"],
                              **extra)
    self.check_port_config(cfg)
    return cfg

  def check_port_config(self, cfg) -> None:
    """The program's configuration has to be the file's: raise otherwise."""
    wrong = [f"{k}: file {v!r}, port {getattr(cfg, PORT_FIELDS[k])!r}"
             for k, v in self.model.items() if k in PORT_FIELDS
             and getattr(cfg, PORT_FIELDS[k]) != v]
    if tuple(cfg.block_cycle) != (self.model["kind"],):
      wrong.append(f"kind: file {self.model['kind']!r}, port "
                   f"{cfg.block_cycle!r}")
    if cfg.router != "soft_topk" or cfg.tie_embeddings or cfg.norm != \
        "rmsnorm" or cfg.mlp_variant != "swiglu":
      wrong.append("router, head, norm or MLP differ from the file's")
    if wrong:
      raise SystemExit("the port's configuration is not the file's: "
                       + "; ".join(wrong))


def forbidden_modules() -> list[str]:
  return sorted({m.split(".")[0] for m in list(sys.modules)}
                & set(FORBIDDEN))


def power_limit() -> str:
  try:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30, check=False)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""
  except (OSError, subprocess.TimeoutExpired):
    return ""


def metric_specs(kind: str) -> list:
  """BENCHMARK.json's metrics of ``kind`` (end_to_end or per_layer)."""
  return load_json(ROOT / "BENCHMARK.json")[kind]


def cell_metrics(env: Env, out: dict, setup_s: float, trace, facts) -> dict:
  name = env.cell["name"]
  e2e = metric_specs("end_to_end")
  mine = {m["name"] for m in e2e if name in m.get("workloads", [name])}
  metrics = {}
  if trace is None:
    for m in e2e:
      if m["name"] not in mine:
        continue
      value = setup_s if m["name"] == "setup_s" else out["metrics"].get(
          m["name"])
      if value is not None:
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    return metrics
  for m in metric_specs("per_layer"):
    cells = m.get("workloads")
    if (name not in cells) if cells else (m["moves"] not in mine):
      continue
    reader = load_module(BENCH / "metrics" / f"{m['name']}.py",
                         f"chipbench_metric_{m['name'].replace('.', '_')}")
    value = reader.read(facts, trace)
    if value is not None and math.isfinite(value):
      metrics[m["name"]] = {"value": value, "unit": m["unit"]}
  return metrics


def cell_class(env: Env):
  """The traffic kind's driver, ``chipbench/traffic/<kind>.py``."""
  kind = env.traffic["kind"]
  return load_module(BENCH / "traffic" / f"{kind}.py",
                     f"chipbench_traffic_{kind}").Cell


def run_cell(env: Env, seconds: float, trace: bool, t0: float) -> dict:
  """One run of ``env``'s cell; the result line as a dict.  Raises
  SystemExit(3) where a forbidden module is loaded once the reference has
  run, just before the line would be printed."""
  import torch
  from chipbench import profiling

  cell = cell_class(env)(env)
  if env.cuda:
    torch.cuda.reset_peak_memory_stats(env.device)
  cell.setup()
  env.mark("warm-up")
  # What set-up made lives to the end: later collections pass it over.
  gc.collect()
  gc.freeze()
  setup_s = time.perf_counter() - t0
  print("set-up by phase: " + ", ".join(
      f"{b[0]} {b[1] - a[1]:.2f} s" for a, b in zip(env.marks, env.marks[1:])),
      file=sys.stderr)
  out = cell.window(seconds)
  reading = None
  if trace:
    run, units = cell.segment()
    reading = profiling.traced(run, units)
  peak = torch.cuda.max_memory_allocated(env.device) if env.cuda else 0
  facts = cell.layer_facts()
  metrics = cell_metrics(env, out, setup_s, reading, facts)
  cell.release()
  readings = cell.readings()
  checks = {k: {"value": readings[k], "limit": v}
            for k, v in env.limits.items()}
  correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                for c in checks.values())
  device = {"platform": "gpu" if env.cuda else "cpu",
            "kind": (torch.cuda.get_device_name(env.device) if env.cuda
                     else "cpu"),
            "count": env.cell.get("chips", 1), "memory_peak_bytes": peak}
  line = {"correct": correct, "attempted": out["attempted"],
          "failed": out["failed"], "metrics": metrics, "device": device}
  if reading is not None:
    device["busy_s"] = reading.busy_s
    device["window_s"] = reading.window_s
    line["breakdown"] = reading.breakdown()
    if reading.short:
      print(f"trace: launches short ({reading.short}): the kernel readings "
            "are left out", file=sys.stderr)
  line["checks"] = checks
  found = forbidden_modules()
  if found:
    print(f"forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
    raise SystemExit(3)
  return line


def main(argv=None) -> int:
  ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  ap.add_argument("--workload", required=True)
  ap.add_argument("--seed", type=int, required=True)
  ap.add_argument("--seconds", type=float, required=True)
  ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
  args = ap.parse_args(argv)
  os.environ.setdefault("PYTORCH_KERNEL_CACHE_PATH",
                        str(ROOT / "build" / "torch_kernels"))
  sys.path.insert(0, str(ROOT / "src"))
  import torch

  env = Env.load(args.workload, args.seed, "cuda")
  env.marks.append(("imports", time.perf_counter()))
  chips = env.cell.get("chips", 1)
  if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
    print(f"needs {chips} CUDA device(s); found "
          f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
          file=sys.stderr)
    return 2
  card = power_limit()
  print(f"card: {card}", file=sys.stderr)
  torch.cuda.init()
  env.mark("CUDA context")
  from repro_torch.kernels import _build
  from repro_torch.launch import steps  # noqa: F401
  env.mark("program import")
  _build.build_all()
  env.mark("kernel build")
  line = run_cell(env, args.seconds, bool(args.trace), _T0)
  line["device"]["power_limit"] = card
  checks = line.pop("checks")
  line["checks"] = checks
  print(f"correct {line['correct']}", file=sys.stderr)
  for k, c in checks.items():
    print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
  print(json.dumps(line), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
