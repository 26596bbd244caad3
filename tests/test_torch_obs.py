"""The port's observability against the reference's (``repro.obs``): the
metrics registry (the same flattened names, counts and histograms for the
same calls, and a disabled registry that records nothing), the schema-v1
BENCH artifacts (a payload of either package passes both validators, and
both refuse the same malformed payloads), and the timing helpers.
Exact comparisons: these are counts, strings and observed samples."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.obs import artifacts as jartifacts  # noqa: E402
from repro.obs import metrics as jmetrics  # noqa: E402
from repro.obs import timing as jtiming  # noqa: E402
from repro_torch.core import soft_rank  # noqa: E402
from repro_torch.obs import artifacts, metrics, timing  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def registries(monkeypatch):
  monkeypatch.delenv("REPRO_METRICS", raising=False)
  monkeypatch.delenv(metrics.ENV_VAR, raising=False)
  for reg in (jmetrics, metrics):
    reg.set_enabled(None)
    reg.reset()
  yield
  for reg in (jmetrics, metrics):
    reg.set_enabled(None)
    reg.reset()


def _record(reg):
  reg.counter_inc("calls", op="sort", reg="l2")
  reg.counter_inc("calls", 2, reg="l2", op="sort")
  reg.counter_inc("other")
  for us in (0.5, 3.0, 1000.0, 1024.0):
    reg.observe("train_step_us", us)
  reg.observe("lat", 7.0, backend="cuda")


def test_snapshot_matches_reference(registries):
  for reg in (jmetrics, metrics):
    _record(reg)
  got, want = metrics.snapshot(), jmetrics.snapshot()
  assert got == want
  assert got["counters"]["calls{op=sort,reg=l2}"] == 3
  h = metrics.histograms("train_step")["train_step_us"]
  assert h["count"] == 4 and h["min"] == 0.5 and h["max"] == 1024.0
  assert h["buckets"] == {"<=2^0": 1, "<=2^2": 1, "<=2^10": 2}
  assert metrics.counter_value("calls", reg="l2", op="sort") == 3


def test_disabled_registry_records_nothing(registries, monkeypatch):
  monkeypatch.setenv(metrics.ENV_VAR, "off")
  assert not metrics.enabled()
  _record(metrics)
  assert metrics.snapshot() == {"enabled": False, "counters": {},
                                "histograms": {}}
  monkeypatch.delenv(metrics.ENV_VAR)
  _record(metrics)
  metrics.set_enabled(False)       # forcing off drops what was recorded
  assert metrics.counters() == {} and metrics.histograms() == {}
  metrics.set_enabled(True)
  metrics.counter_inc("x")
  assert metrics.counters() == {"x": 1}
  metrics.reset()
  assert metrics.snapshot()["counters"] == {}


def test_trainer_observes_step_times(registries):
  from repro_torch.launch import train
  train.main(["--arch", "deepseek-v2-lite-16b", "--smoke", "--device",
              "cpu", "--steps", "2", "--batch", "2", "--seq", "8"])
  h = metrics.histograms()["train_step_us"]
  assert h["count"] == 2 and h["min"] > 0


# ---------------------------------------------------------------------------
# BENCH artifacts.
# ---------------------------------------------------------------------------

RESULTS = [{"name": "t/a", "fwd_us": 12.5, "n": 16, "batch": 2},
           {"name": "t/b", "skipped": "infeasible here"},
           {"name": "t/c", "wall_us": 0.0}]


def test_port_artifact_passes_both_validators(registries, tmp_path):
  soft_rank(torch.randn(2, 16), 0.5)          # dispatch counters
  path = tmp_path / "BENCH_test.json"
  payload = artifacts.write_bench_artifact(
      str(path), RESULTS, artifacts.collect_meta(device="cpu", suite="t"))
  loaded = json.loads(path.read_text())
  assert loaded == json.loads(json.dumps(payload))
  assert artifacts.validate_file(str(path)) == []
  assert jartifacts.validate_file(str(path)) == []
  meta = loaded["meta"]
  assert meta["platform"] == "cpu" and meta["torch"] == torch.__version__
  assert meta["device_kind"] == "cpu" and meta["suite"] == "t"
  assert meta["jax"] == "not used"
  assert any(k.startswith("dispatch_resolve")
             for k in loaded["metrics"]["counters"])


def test_reference_artifact_passes_the_port_validator(tmp_path):
  payload = jartifacts.bench_payload(RESULTS, jartifacts.collect_meta())
  assert jartifacts.validate_bench_payload(payload) == []
  assert artifacts.validate_bench_payload(payload) == []


@pytest.mark.parametrize("mutate", [
    lambda p: p.pop("schema"),
    lambda p: p["meta"].pop("git_sha"),
    lambda p: p["meta"].update(jax=""),
    lambda p: p.pop("metrics"),
    lambda p: p["metrics"]["counters"].update(x=1.5),
    lambda p: p["results"].append({"name": "x"}),
    lambda p: p["results"].append({"name": "x", "fwd_us": float("nan")}),
    lambda p: p["results"].append({"name": "x", "fwd_us": -1.0}),
    lambda p: p["results"].append({"fwd_us": 1.0}),
    lambda p: p["results"].append({"name": "x", "skipped": ""}),
    lambda p: p.update(results={}),
], ids=["schema", "git_sha", "jax", "metrics", "counter", "no-timing",
        "nan", "negative", "no-name", "empty-skip", "results-type"])
def test_both_validators_refuse_the_same_payloads(mutate):
  payload = artifacts.bench_payload([{"name": "ok", "fwd_us": 1.0}],
                                    artifacts.collect_meta(device="cpu"))
  assert artifacts.validate_bench_payload(payload) == []
  mutate(payload)
  errors = artifacts.validate_bench_payload(payload)
  assert errors and errors == jartifacts.validate_bench_payload(payload)


def test_writer_refuses_invalid_results(tmp_path):
  with pytest.raises(ValueError, match="refusing to write"):
    artifacts.write_bench_artifact(str(tmp_path / "BENCH_bad.json"),
                                   [{"name": "no-timing"}])
  assert not (tmp_path / "BENCH_bad.json").exists()


def test_validator_cli(tmp_path):
  good = tmp_path / "BENCH_good.json"
  artifacts.write_bench_artifact(str(good), [{"name": "a", "fwd_us": 1.0}],
                                 artifacts.collect_meta(device="cpu"))
  bad = tmp_path / "BENCH_bad.json"
  bad.write_text("{}")
  assert artifacts.main([str(good)]) == 0
  assert artifacts.main([str(good), str(bad)]) == 1
  assert artifacts.main([]) == 2
  env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
  for paths, rc in (([good], 0), ([good, bad], 1)):
    proc = subprocess.run([sys.executable, "-m", "repro_torch.obs",
                           *map(str, paths)], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == rc, proc.stdout + proc.stderr


# ---------------------------------------------------------------------------
# Timing.
# ---------------------------------------------------------------------------


def test_percentiles_match_reference():
  samples = list(np.random.default_rng(3).gamma(2.0, 10.0, 101))
  for qs in ((50, 95, 99), (1, 100), (0,)):
    assert timing.percentiles(samples, qs) == jtiming.percentiles(samples,
                                                                  qs)
  assert timing.percentiles([], (50, 99)) == (0.0, 0.0)


def test_time_fn_observes_every_measured_call(registries):
  x = torch.randn(4, 32)
  out, dt = timing.timed(soft_rank, x)
  assert out.shape == x.shape and dt > 0
  us = timing.time_fn(soft_rank, x, warmup=1, iters=3, name="rank")
  assert us > 0
  assert metrics.histograms("bench_us")["bench_us{name=rank}"]["count"] == 3
  with timing.wall_timer() as t:
    soft_rank(x)
  assert t.us == t.seconds * 1e6 > 0
