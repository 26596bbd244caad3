"""Structured ``BENCH_*.json`` artifacts: one schema, one emitter, one gate.

Counterpart of ``repro.obs.artifacts``, schema ``repro.bench/v1``::

  {
    "schema": "repro.bench/v1",
    "meta": {"git_sha": "<40-hex or 'unknown'>", "platform": "gpu|cpu",
             "torch": "<version>", "jax": "not used", ...free-form extras},
    "metrics": {"enabled": true, "counters": {...}, "histograms": {...}},
    "results": [{"name": "serve/engine_stream", "wall_us": 1.2e6, ...},
                {"name": "...", "skipped": "why"}]
  }

``launch/train.py`` and ``launch/serve.py`` write through
:func:`write_bench_artifact`, which refuses to write a payload that
:func:`validate_bench_payload` rejects; ``python -m repro_torch.obs
FILE...`` validates files.  The contract is the reference's: a result needs
a string ``name`` and either a ``skipped`` reason or at least one finite,
non-negative ``*_us`` field; ``meta`` needs ``git_sha``, ``platform`` and
``jax``.  The port records torch's version under ``torch`` and writes
``"jax": "not used"``, so an artifact of either package passes the other's
validator.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch

from repro_torch.obs import metrics

SCHEMA_VERSION = "repro.bench/v1"

# The reference's required keys, so each package's validator accepts the
# other's artifacts (the port writes "jax": "not used").
_META_REQUIRED = ("git_sha", "platform", "jax")


def git_sha() -> str:
  """The checkout's commit sha, or 'unknown' outside a git checkout."""
  try:
    out = subprocess.run(
        ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
        timeout=10, check=False, cwd=os.path.dirname(__file__))
    sha = out.stdout.strip()
    return sha if out.returncode == 0 and sha else "unknown"
  except (OSError, subprocess.SubprocessError):
    return "unknown"


def collect_meta(device=None, **extra) -> dict:
  """Standard provenance block: sha, platform, versions + caller extras.

  ``platform`` is ``"gpu"`` when ``device`` (default: the card if there is
  one) is a CUDA device, else ``"cpu"``; ``device_kind`` is the card's
  name.  Where the reference records jax's version the port records
  torch's (``torch``, with CUDA's under ``cuda``); ``jax`` says "not used",
  for the schema's required key.
  """
  if device is None:
    device = "cuda" if torch.cuda.is_available() else "cpu"
  device = torch.device(device)
  gpu = device.type == "cuda"
  meta = {
      "git_sha": git_sha(),
      "platform": "gpu" if gpu else "cpu",
      "torch": torch.__version__,
      "jax": "not used",
      "cuda": torch.version.cuda or "none",
      "device_kind": (torch.cuda.get_device_name(device) if gpu
                      else "cpu"),
      "python": sys.version.split()[0],
      "unix_time": int(time.time()),
  }
  meta.update(extra)
  return meta


def bench_payload(results: list[dict], meta: dict | None = None) -> dict:
  """Assemble a schema-v1 payload: results + meta + live metrics snapshot."""
  return {
      "schema": SCHEMA_VERSION,
      "meta": meta if meta is not None else collect_meta(),
      "metrics": metrics.snapshot(),
      "results": list(results),
  }


def write_bench_artifact(path: str, results: list[dict],
                         meta: dict | None = None) -> dict:
  """Validate and write a ``BENCH_*.json`` artifact; returns the payload.

  Emitting an invalid artifact raises immediately — producers fail at the
  source instead of CI discovering a malformed upload later.
  """
  payload = bench_payload(results, meta)
  errors = validate_bench_payload(payload)
  if errors:
    raise ValueError(f"refusing to write invalid {path}: {errors}")
  with open(path, "w") as f:
    json.dump(payload, f, indent=2, sort_keys=True)
  print(f"wrote {path} ({len(payload['results'])} results)")
  return payload


def _finite_number(v) -> bool:
  return (isinstance(v, (int, float)) and not isinstance(v, bool)
          and v == v and abs(v) != float("inf"))


def validate_bench_payload(payload) -> list[str]:
  """Schema-v1 check; returns a list of human-readable errors ([] = valid)."""
  errs: list[str] = []
  if not isinstance(payload, dict):
    return [f"payload must be an object, got {type(payload).__name__}"]
  if payload.get("schema") != SCHEMA_VERSION:
    errs.append(f"schema must be {SCHEMA_VERSION!r}, "
                f"got {payload.get('schema')!r}")

  meta = payload.get("meta")
  if not isinstance(meta, dict):
    errs.append("meta must be an object")
  else:
    for k in _META_REQUIRED:
      if not isinstance(meta.get(k), str) or not meta[k]:
        errs.append(f"meta.{k} must be a non-empty string")

  mx = payload.get("metrics")
  if not isinstance(mx, dict):
    errs.append("metrics must be an object")
  else:
    if not isinstance(mx.get("counters"), dict):
      errs.append("metrics.counters must be an object")
    elif not all(isinstance(v, int) for v in mx["counters"].values()):
      errs.append("metrics.counters values must be integers")
    if not isinstance(mx.get("histograms"), dict):
      errs.append("metrics.histograms must be an object")

  results = payload.get("results")
  if not isinstance(results, list):
    errs.append("results must be a list")
    return errs
  for i, rec in enumerate(results):
    where = f"results[{i}]"
    if not isinstance(rec, dict):
      errs.append(f"{where} must be an object")
      continue
    if not isinstance(rec.get("name"), str) or not rec["name"]:
      errs.append(f"{where}.name must be a non-empty string")
    if "skipped" in rec:
      if not isinstance(rec["skipped"], str) or not rec["skipped"]:
        errs.append(f"{where}.skipped must be a non-empty reason string")
      continue
    timing_keys = [k for k in rec if k.endswith("_us")]
    if not timing_keys:
      errs.append(f"{where} needs a '*_us' timing field or a "
                  f"'skipped' reason (name={rec.get('name')!r})")
    for k in timing_keys:
      if not _finite_number(rec[k]) or rec[k] < 0:
        errs.append(f"{where}.{k} must be a finite non-negative number, "
                    f"got {rec[k]!r}")
  return errs


def validate_file(path: str) -> list[str]:
  """Validate one artifact file; unreadable/unparsable counts as invalid."""
  try:
    with open(path) as f:
      payload = json.load(f)
  except (OSError, json.JSONDecodeError) as e:
    return [f"{path}: cannot load: {e}"]
  return [f"{path}: {e}" for e in validate_bench_payload(payload)]


def main(argv: list[str] | None = None) -> int:
  """CLI: ``python -m repro_torch.obs BENCH_*.json``; 0 when all valid."""
  paths = sys.argv[1:] if argv is None else argv
  if not paths:
    print("usage: python -m repro_torch.obs BENCH_*.json", file=sys.stderr)
    return 2
  failures = 0
  for path in paths:
    errors = validate_file(path)
    if errors:
      failures += 1
      for e in errors:
        print(f"INVALID {e}", file=sys.stderr)
    else:
      print(f"ok {path}")
  return 1 if failures else 0


if __name__ == "__main__":
  raise SystemExit(main())
