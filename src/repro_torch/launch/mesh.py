"""Device meshes: the production shapes, small debug meshes, fake groups.

Counterpart of ``repro.launch.mesh``.  Functions, not module constants:
importing this module touches no device and no process group.  A mesh is
a ``torch.distributed.device_mesh.DeviceMesh`` over a process group of
``prod(shape)`` ranks that the caller has started (``init_process_group``
with NCCL on the card, gloo on the CPU), or, for the dry run, a fake group
(``fake_process_group``): every collective of a fake group returns at
once, so one process traces what each of 256 or 512 ranks would run.
"""

from __future__ import annotations

import contextlib
import math

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def _make_mesh(shape, axes, device_type: str) -> DeviceMesh:
  shape, axes = tuple(shape), tuple(axes)
  if len(shape) != len(axes):
    raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
  if not dist.is_initialized():
    raise RuntimeError(f"a {shape} mesh needs a process group of "
                       f"{math.prod(shape)} ranks; none is initialized")
  if dist.get_world_size() != math.prod(shape):
    raise ValueError(f"a {shape} mesh needs {math.prod(shape)} ranks; the "
                     f"process group has {dist.get_world_size()}")
  return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
  """(16, 16) over ("data", "model"), or (2, 16, 16) over ("pod", "data",
  "model") with ``multi_pod``."""
  shape, axes = PRODUCTION[multi_pod]
  return _make_mesh(shape, axes, device_type)


def make_debug_mesh(shape=(2, 4), axes=("data", "model"),
                    device_type: str = "cuda") -> DeviceMesh:
  """A small mesh for tests (needs a group of ``prod(shape)`` ranks)."""
  return _make_mesh(shape, axes, device_type)


def data_axes_of(mesh) -> tuple[str, ...]:
  return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


@contextlib.contextmanager
def fake_process_group(world_size: int, rank: int = 0):
  """A fake process group of ``world_size`` ranks, this process being
  ``rank``, destroyed on exit.  The default group is global to the
  process, so this refuses to start over a live one."""
  # The one import of torch's fake backend (torch.testing._internal: no
  # public home); it registers the "fake" backend.
  from torch.testing._internal.distributed.fake_pg import FakeStore
  if dist.is_initialized():
    raise RuntimeError("a process group is already initialized; destroy it "
                       "before starting a fake one")
  dist.init_process_group("fake", store=FakeStore(), rank=rank,
                          world_size=world_size)
  try:
    yield
  finally:
    dist.destroy_process_group()
