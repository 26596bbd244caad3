"""The dry run end to end, at smoke size: ``python -m
repro_torch.launch.dryrun`` over one cell of each kind on fake meshes
(2, 4) over (data, model) in place of 16 x 16 and (2, 2, 2) over (pod,
data, model) in place of 2 x 16 x 16, with the smoke llama3.2-1b at 2
layers and small cells.  Every cell traces (``status`` ok, with the
reference's record keys and the roofline's), ``long_500k`` is skipped with
the reference's reason, the per-op tables are written, the exit code is
0, a cell that fails is recorded as ``error`` with exit code 1, and the
report renders both tables.
"""

from __future__ import annotations

import dataclasses
import json
import os

import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import report  # noqa: E402
from repro_torch.configs.smoke import smoke_config  # noqa: E402
from repro_torch.launch import dryrun, mesh, shapes  # noqa: E402

ARCH = "llama3.2-1b"
CELLS = {
    "train_s": shapes.ShapeCell("train_s", 16, 8, "train"),
    "prefill_s": shapes.ShapeCell("prefill_s", 16, 8, "prefill"),
    "decode_s": shapes.ShapeCell("decode_s", 16, 8, "decode"),
    "long_500k": shapes.ShapeCell("long_500k", 64, 1, "decode"),
}
ROOF_KEYS = {"compute_s", "memory_s", "collective_s", "dominant", "bound_s",
             "model_flops", "hlo_flops_total", "useful_flops_ratio",
             "roofline_fraction"}


@pytest.fixture
def smoke_dryrun(monkeypatch, tmp_path):
  monkeypatch.setattr(dryrun, "get_config", lambda arch: dataclasses.replace(
      smoke_config(arch), num_layers=2))
  monkeypatch.setattr(shapes, "SHAPES", CELLS)
  monkeypatch.setitem(mesh.PRODUCTION, False, ((2, 4), ("data", "model")))
  monkeypatch.setitem(mesh.PRODUCTION, True,
                      ((2, 2, 2), ("pod", "data", "model")))
  return str(tmp_path)


def test_every_kind_of_cell_traces_and_the_report_renders(smoke_dryrun):
  out = smoke_dryrun
  assert dryrun.main(["--arch", ARCH, "--mesh", "both", "--out", out,
                      "--keep-ops"]) == 0
  for mesh_name, devices in (("single", 8), ("multi", 8)):
    for name, cell in CELLS.items():
      with open(os.path.join(out, f"{ARCH}__{name}__{mesh_name}.json")) as f:
        rec = json.load(f)
      if name == "long_500k":
        assert rec["status"] == "skipped"
        assert rec["reason"] == shapes.cell_applicable(
            smoke_config(ARCH), cell)[1]
        continue
      assert rec["status"] == "ok", rec.get("traceback")
      assert rec["devices"] == devices and rec["trace_s"] >= 0
      assert rec["params_active"] <= rec["params_total"]
      assert set(rec["roofline"]) == ROOF_KEYS
      cost = rec["cost"]
      assert cost["flops_per_device"] > 0 and cost["hbm_bytes_per_device"] > 0
      assert cost["collective_bytes_per_device"] == sum(
          cost["collectives_by_type"].values()) > 0
      mem = rec["memory"]
      assert mem["peak_estimate_bytes"] == (mem["argument_bytes"]
                                            + mem["traced_peak_bytes"])
      with open(rec["ops_path"]) as f:
        ops = json.load(f)
      assert sum(r["flops"] for r in ops) == cost["flops_per_device"]
  single = report.load_cells(out, "single")
  multi = report.load_cells(out, "multi")
  assert len(single) == len(multi) == len(CELLS)
  table = report.dryrun_table(single, multi)
  roof = report.roofline_table(single)
  assert table.count(f"| {ARCH} |") == roof.count(f"| {ARCH} |") == len(CELLS)
  assert "skip" in table and "**" in roof


def test_a_failing_cell_is_recorded_and_exits_1(smoke_dryrun, monkeypatch):
  def broken(*args, **kwargs):
    raise RuntimeError("broken step")
  monkeypatch.setattr(dryrun.ST, "make_prefill_step", broken)
  assert dryrun.main(["--arch", ARCH, "--shape", "prefill_s", "--out",
                      smoke_dryrun]) == 1
  with open(os.path.join(smoke_dryrun,
                         f"{ARCH}__prefill_s__single.json")) as f:
    rec = json.load(f)
  assert rec["status"] == "error" and "broken step" in rec["error"]
  # the group is gone: another cell can start one
  assert not torch.distributed.is_initialized()
