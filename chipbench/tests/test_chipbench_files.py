"""The benchmark's files: each cell, configuration, traffic mix and metric
is found by its name, and BENCHMARK.json keeps to its schema and limits."""

from __future__ import annotations

import json
import math
import re

import pytest

from chipbench import run as R

BENCH = json.loads((R.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
  assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
  assert BENCH["paths"] == ["chipbench"]
  assert 1 <= BENCH["run_seconds"] <= 51
  assert len((R.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_check_fits_with_every_cell():
  s = BENCH["run_seconds"]
  assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names(kind):
  names = [e["name"] for e in BENCH[kind]]
  assert len(names) == len(set(names))
  assert all(NAME.match(n) for n in names)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_by_name(cell):
  w = next(w for w in BENCH["workloads"] if w["name"] == cell)
  assert set(w) == {"name", "config", "traffic", "chips", "why"}
  assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
  env = R.Env.load(cell, 1, "cpu")
  assert env.config["name"] == w["config"]
  assert (R.BENCH / "traffic" / f"{env.traffic['kind']}.py").is_file()
  assert set(env.limits) and all(v > 0 for v in env.limits.values())
  mine = [m for m in BENCH["end_to_end"]
          if cell in m.get("workloads", [cell])]
  assert "setup_s" in {m["name"] for m in mine} and len(mine) >= 2
  assert any(cell in m["workloads"] for m in BENCH["per_layer"])


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(entry):
  assert set(entry) == {"name", "source", "file", "reduced", "why"}
  cfg = json.loads((R.ROOT / entry["file"]).read_text())
  assert cfg["name"] == entry["name"] and cfg["reduced"] == entry["reduced"]
  assert entry["file"].startswith("chipbench/configs/")
  assert len(entry["reduced"]) <= 16 and all(NAME.match(k)
                                             for k in entry["reduced"])
  widths = [k for k in entry["reduced"]
            if k.endswith(("_dim", "_rank", "_size", "width"))
            or "hidden" in k and "layers" not in k or "intermediate" in k]
  assert widths == []
  assert cfg["assumed"] and cfg["deployment"]
  assert any(w["config"] == entry["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("metric", BENCH["end_to_end"],
                         ids=lambda m: m["name"])
def test_end_to_end(metric):
  assert metric["better"] in ("lower", "higher") and UNIT.match(
      metric["unit"])
  assert metric["source"] in ("host_clock", "device_trace")
  assert 0.01 <= metric["bound"] <= 0.25
  for cell in metric.get("workloads", []):
    assert cell in CELLS


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_per_layer_reader(metric):
  reader = R.load_module(R.BENCH / "metrics" / f"{metric['name']}.py",
                         "reader_" + metric["name"].replace(".", "_"))
  assert (reader.LAYER, reader.UNIT, reader.SOURCE, reader.MOVES) == (
      metric["layer"], metric["unit"], metric["source"], metric["moves"])
  moves = next(m for m in BENCH["end_to_end"]
               if m["name"] == metric["moves"])
  assert set(metric["workloads"]) <= set(moves["workloads"])
  assert set(metric) <= {"name", "unit", "better", "source", "layer",
                         "moves", "workloads"}


def test_four_chip_share():
  four = sum(w["chips"] == 4 for w in BENCH["workloads"])
  assert four <= max(1, math.floor(0.25 * len(CELLS)))
