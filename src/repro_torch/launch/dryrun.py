"""Multi-pod dry run: trace every (arch x shape x mesh) cell, no devices.

Counterpart of ``repro.launch.dryrun``.  For each cell this starts a fake
process group of 256 or 512 ranks and the production mesh (16 x 16, or
2 x 16 x 16 multi-pod), builds the model at full width on fake tensors
(``analysis.cost.CostMode``, a ``FakeTensorMode``: shapes, no data),
distributes parameters, optimizer state, batch or caches by the sharding
rules, runs the port's own train, prefill or decode step once under
``use_rules``, and records what one rank ran: FLOPs, memory bytes,
collective bytes by type, the arguments' per-device bytes and the traced
peak, and the roofline terms (``analysis.roofline``, the H100's
constants) into ``experiments/dryrun_torch/<cell>.json``.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-12b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

Variants apply config overrides and tag the output:
  --set seq_shard_activations=True --set q_chunk=1024 --tag spq1024
``--keep-ops`` also writes each cell's per-op cost table
(``<cell>.ops.json``; the reference's ``--keep-hlo`` writes its HLO).

The trace counts what the card runs, on the CPU's fake tensors: the
attention kernel's launch as one op with the kernel's FLOPs (its plain
version, 20 ops a pair of chunks, took ~800 s to trace at prefill_32k),
its backward's PyTorch ops; the gates' plain version; the sLSTM scan one
step traced and counted for each position (``analysis.cost.counted_as``).
The isotonic solves go to the loop-free ``minimax`` backend
(``DRYRUN_PLAN``), the reference's choice for its router, since the other
solvers read values to end their loops and fake tensors have none.  Each
cell takes seconds to minutes: run one process per architecture for
``--all``.  The exit code is 1 if any cell errs.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

import torch

from repro_torch import plan as repro_plan
from repro_torch.analysis.cost import CostMode
from repro_torch.analysis.roofline import (count_active_params, model_flops,
                                           roofline_terms)
from repro_torch.configs.base import ASSIGNED, get_config
from repro_torch.launch import mesh as M
from repro_torch.launch import shapes as SH
from repro_torch.launch import steps as ST
from repro_torch.launch.serve import parse_overrides
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.sharding import specs as SP
from torch.distributed.tensor import DTensor

DEFAULT_OUT = os.path.join(os.path.dirname(__file__),
                           "../../../experiments/dryrun_torch")

DRYRUN_PLAN = repro_plan.ExecutionPlan(
    name="dryrun",
    rules=(repro_plan.PlanRule("forward", "minimax", op="isotonic"),
           repro_plan.PlanRule("backward", "segscan"),
           repro_plan.PlanRule("projection", "fused", op="projection")))


def _local_bytes(tree) -> int:
  """Bytes of this rank's blocks of the tensors in a dict/list tree."""
  if isinstance(tree, dict):
    return sum(_local_bytes(v) for v in tree.values())
  if isinstance(tree, (list, tuple)):
    return sum(_local_bytes(v) for v in tree)
  if isinstance(tree, DTensor):
    tree = tree.to_local()
  return tree.numel() * tree.element_size() if torch.is_tensor(tree) else 0


def _distribute_batch(rules, batch: dict) -> dict:
  return SP.distribute_tree(batch, rules.mesh,
                            SP.batch_specs_tree(rules, batch))


def trace_cell(cfg, cell: SH.ShapeCell, mesh_shape, axes) -> dict:
  """Trace one cell on a fake group of ``prod(mesh_shape)`` ranks; returns
  the record's measured fields (raises where the step does)."""
  n_dev = math.prod(mesh_shape)
  with M.fake_process_group(n_dev):
    mesh = M.make_debug_mesh(mesh_shape, axes, device_type="cpu")
    rules = SP.ShardingRules(
        mesh, data_axes=M.data_axes_of(mesh), model_axis="model",
        seq_shard_activations=cfg.seq_shard_activations, fsdp=cfg.fsdp)
    mode = CostMode()
    with mode, repro_plan.use_plan(DRYRUN_PLAN):
      model = T.init_params(cfg, 0, "cpu")
      total, active = count_active_params(cfg, model)
      mflops = model_flops(cfg, model, cell)
      SP.distribute_model(model, mesh, SP.param_specs_tree(rules, model))
      if cell.kind == "train":
        model.requires_grad_(True)
        opt_cfg = adamw.AdamWConfig(
            moment_dtype="bfloat16" if cfg.fsdp else "float32")
        opt = ST.init_opt_state(cfg, opt_cfg,
                                dict(model.named_parameters()))
        batch = _distribute_batch(rules, SH.batch_specs(cfg, cell, "cpu"))
        step, args = ST.make_train_step(cfg, opt_cfg), (model, opt, batch)
        arg_trees = (dict(model.named_parameters()), opt, batch)
      elif cell.kind == "prefill":
        batch = _distribute_batch(rules, SH.batch_specs(cfg, cell, "cpu"))
        step, args = ST.make_prefill_step(cfg), (model, batch)
        arg_trees = (dict(model.named_parameters()), batch)
      else:
        caches = T.init_cache_sharded(cfg, cell.global_batch, cell.seq_len,
                                      rules)
        tok = SH.decode_token_specs(cfg, cell, "cpu")
        tok = SP.distribute(tok, mesh, SP.batch_spec(rules, tok.shape))
        step = ST.make_decode_step(cfg)
        args = (model, caches, tok, cell.seq_len - 1)
        arg_trees = (dict(model.named_parameters()), caches, tok)
      arg_bytes = _local_bytes(arg_trees)
      mode.reset()
      t0 = time.perf_counter()
      with SP.use_rules(rules), torch.set_grad_enabled(cell.kind == "train"):
        step(*args)
      trace_s = time.perf_counter() - t0
      cost = mode.analyze()
      ops = mode.op_table()
  peak = cost.pop("traced_peak_bytes")
  return {
      "devices": n_dev,
      "trace_s": round(trace_s, 2),
      "params_total": total,
      "params_active": active,
      "memory": {"argument_bytes": arg_bytes, "traced_peak_bytes": peak,
                 "peak_estimate_bytes": arg_bytes + peak},
      "cost": cost,
      "roofline": roofline_terms(cost, n_dev, mflops),
      "ops": ops,
  }


def run_cell(arch, shape_name, multi_pod, overrides, outdir, force=False,
             tag="", keep_ops=False) -> dict:
  mesh_name = "multi" if multi_pod else "single"
  cell_id = f"{arch}__{shape_name}__{mesh_name}" + (f"__{tag}" if tag else "")
  os.makedirs(outdir, exist_ok=True)
  path = os.path.join(outdir, cell_id + ".json")
  if os.path.exists(path) and not force:
    print(f"[skip] {cell_id} (cached)")
    with open(path) as f:
      return json.load(f)

  cfg = get_config(arch)
  if overrides:
    cfg = dataclasses.replace(cfg, **overrides)
  cell = SH.SHAPES[shape_name]
  ok, why = SH.cell_applicable(cfg, cell)
  record = {"arch": arch, "shape": shape_name, "mesh": mesh_name, "tag": tag,
            "overrides": overrides or {}}
  if not ok:
    record.update({"status": "skipped", "reason": why})
    print(f"[skip] {cell_id}: {why}")
  else:
    mesh_shape, axes = M.PRODUCTION[multi_pod]
    try:
      got = trace_cell(cfg, cell, mesh_shape, axes)
      ops = got.pop("ops")
      record.update({"status": "ok", **got})
      if keep_ops:
        ops_path = os.path.join(outdir, cell_id + ".ops.json")
        with open(ops_path, "w") as f:
          json.dump(ops, f, indent=1)
        record["ops_path"] = ops_path
      roof, mem = record["roofline"], record["memory"]
      print(f"[ok]   {cell_id}: trace {record['trace_s']:.1f}s, "
            f"dominant={roof['dominant']} ({roof['bound_s'] * 1e3:.2f} ms), "
            f"roofline_frac={roof['roofline_fraction']:.3f}, "
            f"mem/dev={mem['peak_estimate_bytes'] / 2**30:.2f} GiB")
    except Exception as e:  # noqa: BLE001  (recorded: a bug to fix)
      record.update({"status": "error", "error": repr(e),
                     "traceback": traceback.format_exc()})
      print(f"[FAIL] {cell_id}: {e!r}")
  with open(path, "w") as f:
    json.dump(record, f, indent=1)
  return record


def main(argv=None) -> int:
  ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  ap.add_argument("--arch", default=None)
  ap.add_argument("--shape", default=None, choices=list(SH.SHAPES) + [None])
  ap.add_argument("--mesh", default="single",
                  choices=["single", "multi", "both"])
  ap.add_argument("--all", action="store_true")
  ap.add_argument("--force", action="store_true")
  ap.add_argument("--keep-ops", action="store_true",
                  help="also write each cell's per-op cost table")
  ap.add_argument("--out", default=DEFAULT_OUT)
  ap.add_argument("--tag", default="")
  ap.add_argument("--set", action="append", dest="overrides",
                  help="config override key=value (repeatable)")
  args = ap.parse_args(argv)

  archs = list(ASSIGNED) if (args.all or not args.arch) else [args.arch]
  shapes = list(SH.SHAPES) if (args.all or not args.shape) else [args.shape]
  meshes = {"single": [False], "multi": [True],
            "both": [False, True]}[args.mesh]
  overrides = parse_overrides(args.overrides)

  n_fail = 0
  for arch in archs:
    for shape in shapes:
      for multi in meshes:
        rec = run_cell(arch, shape, multi, overrides, args.out,
                       force=args.force, tag=args.tag,
                       keep_ops=args.keep_ops)
        n_fail += rec.get("status") == "error"
  return 1 if n_fail else 0


if __name__ == "__main__":
  raise SystemExit(main())
