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

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
CHECKOUT = Path(__file__).resolve().parents[3]
BUILD_DIR = CHECKOUT / "build" / "repro_torch_kernels"

# No --use_fast_math: its expf / log1pf approximations move the kl values.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_LOG: dict[str, str] = {}   # nvcc's output per source (ptxas -v)


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
  for name, (source, lib) in targets.items():
    if lib.exists():
      continue
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    procs[name] = (subprocess.Popen(
        [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, lib)
  failed = []
  for name, (proc, tmp, lib) in procs.items():
    log, _ = proc.communicate()
    BUILD_LOG[name] = log
    if proc.returncode != 0:
      failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
      continue
    os.replace(tmp, lib)  # atomic: a concurrent build sees all or nothing
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
