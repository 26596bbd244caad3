"""Build the CUDA sources in ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C interface,
``build/repro_torch_kernels/<name>-<hash>.so`` under the checkout root,
where the hash covers the sources, the flags and the compiler.  All sources
compile in parallel, one nvcc process each, at first use; a library whose
hash already exists is reused.  A missing nvcc or a failed build raises:
there is no fallback.  So does a package imported from anywhere but a
checkout's ``src/``: the build writes only inside the checkout.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable

CSRC = Path(__file__).resolve().parent / "csrc"
CHECKOUT = Path(__file__).resolve().parents[3]
BUILD_DIR = CHECKOUT / "build" / "repro_torch_kernels"

# No --use_fast_math: its expf / log1pf approximations move the kl values.
# --split-compile=0 optimizes a source's kernels in parallel, one thread a
# core (flash_attention_simt.cu holds 34 instantiations).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "--split-compile=0")

_LIBS: dict[str, ctypes.CDLL] = {}
_ENTRIES: dict[tuple[str, str], Callable[..., int]] = {}
BUILD_LOG: dict[str, str] = {}   # nvcc's output per source (ptxas -v)
BUILD_SECONDS: dict[str, float] = {}   # per source, from start to exit


def nvcc_path() -> str:
  """The nvcc on PATH, else the toolkit's default location; raises if none."""
  found = shutil.which("nvcc")
  if found:
    return found
  default = "/usr/local/cuda/bin/nvcc"
  if os.access(default, os.X_OK):
    return default
  raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch are "
                     "built from source and need the CUDA toolkit")


def _library_path(source: Path, nvcc: str) -> Path:
  digest = hashlib.sha256()
  for part in [source.read_bytes(), " ".join(NVCC_FLAGS).encode(),
               nvcc.encode()] + [h.read_bytes()
                                 for h in sorted(CSRC.glob("*.cuh"))]:
    digest.update(part)
  return BUILD_DIR / f"{source.stem}-{digest.hexdigest()[:16]}.so"


def build_all() -> dict[str, Path]:
  """Compile every ``csrc/*.cu`` not yet built, in parallel; name -> .so."""
  if not ((CHECKOUT / "pyproject.toml").is_file()
          and (CHECKOUT / "src" / "repro_torch").is_dir()):
    raise RuntimeError(
        f"repro_torch is imported from {CSRC.parent.parent}, not from a "
        "checkout's src/: its kernels build only inside a checkout; put the "
        "checkout's src/ first on PYTHONPATH")
  nvcc = nvcc_path()
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  targets = {s.stem: (s, _library_path(s, nvcc))
             for s in sorted(CSRC.glob("*.cu"))}
  procs = {}
  t0 = time.perf_counter()
  for name, (source, lib) in targets.items():
    if lib.exists():
      continue
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    log = tmp.with_suffix(".log").open("w+")
    procs[name] = (subprocess.Popen(
        [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source)],
        stdout=log, stderr=subprocess.STDOUT), log, tmp, lib)
  failed = []
  while procs:   # poll, so each source's seconds end when its nvcc exits
    for name, (proc, log, tmp, lib) in list(procs.items()):
      if proc.poll() is None:
        continue
      BUILD_SECONDS[name] = time.perf_counter() - t0
      log.seek(0)
      BUILD_LOG[name] = log.read()
      log.close()
      os.remove(log.name)
      del procs[name]
      if proc.returncode != 0:
        failed.append(f"{name}: nvcc exited {proc.returncode}\n"
                      f"{BUILD_LOG[name]}")
      else:
        os.replace(tmp, lib)  # atomic: a concurrent build sees all or none
    time.sleep(0.05)
  if failed:
    raise RuntimeError("building the CUDA kernels failed:\n" +
                       "\n".join(failed))
  return {name: lib for name, (_, lib) in targets.items()}


def library(name: str) -> ctypes.CDLL:
  """The loaded library of ``csrc/<name>.cu``, building all at first use."""
  lib = _LIBS.get(name)
  if lib is None:
    paths = build_all()
    if name not in paths:
      raise RuntimeError(f"no CUDA source csrc/{name}.cu")
    lib = _LIBS[name] = ctypes.CDLL(str(paths[name]))
  return lib


def entry(name: str, fn: str, argtypes: list, restype=ctypes.c_int):
  """The C function ``fn`` of ``csrc/<name>.cu``, typed, bound once (a
  wrapper calls it on every launch)."""
  f = _ENTRIES.get((name, fn))
  if f is None:
    f = getattr(library(name), fn)
    f.argtypes = argtypes
    f.restype = restype
    _ENTRIES[(name, fn)] = f
  return f


def on_device(device):
  """``torch.cuda.device(device)`` around a launch, or nothing when
  ``device`` is already the current device (the usual case: the context
  costs host time on every call)."""
  import torch

  if device.index is None or device.index == torch.cuda.current_device():
    return contextlib.nullcontext()
  return torch.cuda.device(device)


def current_stream(device) -> int:
  """The raw handle of the current CUDA stream on ``device``: PyTorch's own
  accessor, without the Stream object that ``torch.cuda.current_stream``
  builds on every call."""
  import torch

  return torch._C._cuda_getCurrentRawStream(device.index)
