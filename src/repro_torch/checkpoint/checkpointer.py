"""Checkpoints: atomic, asynchronous, keep-N, device-independent.

Counterpart of ``repro.checkpoint.checkpointer``, with its on-disk layout:
one directory ``step_<n>`` (n zero-padded to 10 digits) per step holding

  manifest.json   keys, shapes, dtypes and the caller's metadata
  arrays.npz      the leaves, keyed by their path in the tree

A tree is a nested dict whose leaves are tensors; a key is the path of
dict keys joined by "/", so the trainer's keys are the port's own
parameter names and optimizer paths (``params/layers.0.params.mla.wq``,
``opt/adam/m/...``).  bf16 leaves are stored as their uint16 bits, with
``bfloat16`` in the manifest.  A save writes ``tmp.<step>`` and
``os.replace``s it into place, so a crash mid-write never leaves a
partial ``step_<n>``; only the newest ``keep`` steps stay.  Leaves are
stored gathered on the host, a DTensor as its full tensor, so a checkpoint
does not depend on the mesh it was saved from: ``restore(...,
map_location=)`` places the leaves on any device, and ``restore(...,
mesh=, placements=)`` (the reference's ``shardings=``) distributes them
onto any mesh; a DTensor leaf of ``like`` is restored onto its own mesh
and placements.  Under a process group every rank takes part in a save
(gathering the DTensors) and rank 0 writes.  ``AsyncCheckpointer`` saves
on a background thread, at most one save in flight.
"""

from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

_SEP = "/"


def _flatten(tree: dict, prefix: str = "") -> dict[str, torch.Tensor]:
  flat = {}
  for name, value in tree.items():
    key = f"{prefix}{name}"
    if isinstance(value, dict):
      flat.update(_flatten(value, key + _SEP))
    else:
      flat[key] = value
  return flat


def _to_numpy(t: torch.Tensor) -> np.ndarray:
  if isinstance(t, DTensor):
    t = t.full_tensor()
  t = t.detach().to("cpu", copy=True)   # a CPU leaf too: a snapshot
  if t.dtype == torch.bfloat16:   # numpy has no bf16: store the bits
    return t.view(torch.int16).numpy().view(np.uint16)
  return t.numpy()


def _dtype_name(t: torch.Tensor) -> str:
  return str(t.dtype).removeprefix("torch.")


def _snapshot(tree: dict) -> dict[str, tuple[np.ndarray, str]]:
  """Host copies of every leaf, by key, with the leaf's dtype name."""
  return {k: (_to_numpy(t), _dtype_name(t))
          for k, t in _flatten(tree).items()}


def _write(directory: str, step: int, host: dict, metadata: dict | None,
           keep: int) -> str:
  os.makedirs(directory, exist_ok=True)
  tmp = os.path.join(directory, f"tmp.{step}")
  final = os.path.join(directory, f"step_{step:010d}")
  if os.path.exists(tmp):
    shutil.rmtree(tmp)
  os.makedirs(tmp)
  np.savez(os.path.join(tmp, "arrays.npz"),
           **{k: a for k, (a, _) in host.items()})
  manifest = {
      "step": step,
      "keys": sorted(host),
      "shapes": {k: list(a.shape) for k, (a, _) in host.items()},
      "dtypes": {k: dt for k, (_, dt) in host.items()},
      "metadata": metadata or {},
  }
  with open(os.path.join(tmp, "manifest.json"), "w") as f:
    json.dump(manifest, f)
  if os.path.exists(final):
    shutil.rmtree(final)
  os.replace(tmp, final)
  _gc(directory, keep)
  return final


def _writes() -> bool:
  """Whether this process writes: rank 0 of a process group, or the one
  process without one."""
  return not dist.is_initialized() or dist.get_rank() == 0


def save(directory: str, step: int, tree: dict,
         metadata: dict | None = None, keep: int = 3) -> str:
  """Write ``tree`` as step ``step``; returns the step's directory.  Under
  a process group every rank calls it and it returns once rank 0 has
  written."""
  host = _snapshot(tree)
  path = os.path.join(directory, f"step_{step:010d}")
  if _writes():
    path = _write(directory, step, host, metadata, keep)
  if dist.is_initialized():
    dist.barrier()
  return path


def _gc(directory: str, keep: int) -> None:
  steps = all_steps(directory)
  for s in steps[:-keep] if keep else []:
    shutil.rmtree(os.path.join(directory, f"step_{s:010d}"),
                  ignore_errors=True)


def all_steps(directory: str) -> list[int]:
  if not os.path.isdir(directory):
    return []
  return sorted(int(name.split("_")[1]) for name in os.listdir(directory)
                if name.startswith("step_"))


def latest_step(directory: str) -> int | None:
  steps = all_steps(directory)
  return steps[-1] if steps else None


def _placed(t: torch.Tensor, proto: torch.Tensor, map_location, mesh,
            placements) -> torch.Tensor:
  """A restored full leaf in ``proto``'s dtype: distributed by
  ``placements`` over ``mesh`` where given, else like a DTensor
  ``proto``, else on ``map_location`` or ``proto``'s device."""
  if placements is None and isinstance(proto, DTensor):
    mesh, placements = proto.device_mesh, proto.placements
  if placements is not None:
    t = t.to(device=mesh.device_type, dtype=proto.dtype)
    return distribute_tensor(t, mesh, placements, src_data_rank=None)
  return t.to(device=map_location or proto.device, dtype=proto.dtype)


def restore(directory: str, like: dict, step: int | None = None,
            map_location=None, *, mesh=None,
            placements: dict | None = None) -> tuple[dict, dict]:
  """The checkpoint of ``step`` (default: the latest) in the structure and
  dtypes of ``like``: each leaf on ``like``'s device, or on
  ``map_location`` where given; or, with ``placements`` (a tree like
  ``like`` whose leaves are DTensor placements) and ``mesh``, distributed
  onto that mesh; a DTensor leaf of ``like`` without placements keeps its
  own mesh and placements.  Returns (tree, metadata)."""
  if (mesh is None) != (placements is None):
    raise ValueError("restore takes mesh= and placements= together")
  if step is None:
    step = latest_step(directory)
    if step is None:
      raise FileNotFoundError(f"no checkpoints under {directory}")
  path = os.path.join(directory, f"step_{step:010d}")
  with open(os.path.join(path, "manifest.json")) as f:
    manifest = json.load(f)

  def build(node: dict, places, prefix: str, data) -> dict:
    out = {}
    for name, proto in node.items():
      key = f"{prefix}{name}"
      place = None if places is None else places[name]
      if isinstance(proto, dict):
        out[name] = build(proto, place, key + _SEP, data)
        continue
      arr = data[key]
      t = torch.from_numpy(np.array(arr))
      if manifest["dtypes"][key] == "bfloat16":
        t = t.view(torch.int16).view(torch.bfloat16)
      out[name] = _placed(t, proto, map_location, mesh, place)
    return out

  with np.load(os.path.join(path, "arrays.npz")) as data:
    tree = build(like, placements, "", data)
  return tree, manifest["metadata"]


class AsyncCheckpointer:
  """Saves on a background thread; the caller blocks only when a second
  save comes while the first is still writing."""

  def __init__(self, directory: str, keep: int = 3):
    self.directory = directory
    self.keep = keep
    self._pending: threading.Thread | None = None
    self._error: Exception | None = None

  def save(self, step: int, tree: dict, metadata: dict | None = None):
    self.wait()  # at most one in flight
    host = _snapshot(tree)  # copied before the caller mutates the tree
    if not _writes():
      return

    def work():
      try:
        _write(self.directory, step, host, metadata, self.keep)
      except Exception as e:  # noqa: BLE001  (raised again by wait())
        self._error = e

    self._pending = threading.Thread(target=work, daemon=True)
    self._pending.start()

  def wait(self):
    """Join the save in flight; raise its error, if it failed."""
    if self._pending is not None:
      self._pending.join()
      self._pending = None
    if self._error is not None:
      err, self._error = self._error, None
      raise err
