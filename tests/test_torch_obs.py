"""The port's metrics registry against the reference's (``repro.obs.
metrics``): the same flattened names, counts and histograms for the same
calls, and a disabled registry that records nothing."""

from __future__ import annotations

import pytest

pytest.importorskip("torch")

from repro.obs import metrics as jmetrics  # noqa: E402
from repro_torch.obs import metrics  # noqa: E402


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
