"""Per-device cost of a traced step: FLOPs, memory bytes, collectives.

The port's counterpart of ``repro.analysis.hlo``.  The reference parses the
per-device HLO that XLA compiles for its SPMD program; the port has no HLO,
so ``CostMode`` counts the operations one rank runs while the step is
traced once on fake tensors.  It is a ``FakeTensorMode`` (tensors made
under it have shapes and no data), and as such it sits below DTensor: a
DTensor op reaches it as the ops on the local blocks, plus the
functional collectives of every redistribution.  So what it counts is per
device, the reference's convention:

* FLOPs with ``torch.utils.flop_counter``'s formulas (products,
  convolutions, attention) on the local shapes; the attention kernel's
  launch is one op (``repro_torch::flash_attention``, to which the mode
  sends CPU tensors as the card's are sent) with the kernel's FLOPs, its
  backward the PyTorch ops of ``flash_attention_bwd``;
* memory bytes as the operands plus the results of every op that is not a
  view.  An eager program has no fusion, so every op reads and writes
  memory: this is not the reference's count at fusion boundaries, and an
  elementwise chain costs more here than in XLA's fused program;
* collective bytes by type as the operand bytes of each functional
  collective (the reference's ``hlo.py`` convention), and their counts;
* the peak of the bytes that ops produced and that are still alive, which
  the dry run adds to its arguments' bytes.

A loop of the model runs unrolled in eager mode, so each of L layers is
counted once and no trip counts are needed; the xLSTM's scans, whose steps
run the same ops at the same shapes, trace one step and count it as many
times where autograd records nothing (``counted_as``).  A truth test of a
fake tensor, which has no value to read, reads as true: a loop it guards
runs to its bound (the gates' pooling loop, bounded by E - 2).
``analyze`` returns the reference's ``analyze_text`` keys.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import weakref

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import flash_attention as _fa
from repro_torch.models import xlstm as _xlstm

# Functional collectives, by the reference's names for them.
COLLECTIVES = {
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-broadcast",
}
# Ops that move no data.
_FREE = {"aten::detach", "aten::alias", "aten::lift_fresh", "prim::device",
         "aten::empty", "aten::empty_strided", "aten::empty_like",
         "_c10d_functional::wait_tensor"}


_REPEAT = threading.local()


@contextlib.contextmanager
def counted_as(n: int):
  """Count the ops run inside ``n`` times (their calls, FLOPs and bytes):
  a loop whose iterations run the same ops at the same shapes, traced for
  one iteration (fake tensors hold no values, so no iteration can take
  another branch)."""
  prev = getattr(_REPEAT, "n", 1)
  _REPEAT.n = prev * n
  try:
    yield
  finally:
    _REPEAT.n = prev


def _one_step_counted(s: int):
  """The xLSTM's ``_scan_steps`` under the mode: one of ``s`` steps,
  counted ``s`` times, where autograd records nothing (a step it records
  is traced each time, as each one's backward runs)."""
  if torch.is_grad_enabled():
    return range(s), contextlib.nullcontext()
  return range(1), counted_as(s)


def _nbytes(t: torch.Tensor) -> int:
  """A tensor's bytes in device memory: none for a ``meta`` tensor (shapes
  only, as ``init_cache_sharded`` builds to read the global shapes)."""
  return 0 if t.device.type == "meta" else t.numel() * t.element_size()


def _tensors(tree) -> list[torch.Tensor]:
  return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


class CostMode(FakeTensorMode):
  """A fake-tensor mode that counts the local ops it runs (see the module's
  docstring) between ``reset()`` and ``analyze()``; ``by_op`` keeps, per
  op, its calls, FLOPs and bytes.  While it is entered, CPU tensors go
  to the attention kernel's launch op and the xLSTM's scans trace one
  step (``_one_step_counted``)."""

  def __init__(self):
    super().__init__(allow_non_fake_inputs=True)
    self._depth = 0
    self._entered = 0
    self.reset()

  def __enter__(self):
    if not self._entered:
      self._hooks = (_xlstm._scan_steps, set(_fa.KERNEL_DEVICES))
      _xlstm._scan_steps = _one_step_counted
      _fa.KERNEL_DEVICES.add("cpu")
    self._entered += 1
    return super().__enter__()

  def __exit__(self, *exc):
    try:
      return super().__exit__(*exc)
    finally:
      self._entered -= 1
      if not self._entered:
        _xlstm._scan_steps, devices = self._hooks
        _fa.KERNEL_DEVICES.clear()
        _fa.KERNEL_DEVICES.update(devices)

  def reset(self) -> None:
    self.flops = 0
    self.hbm_bytes = 0
    self.collectives = collections.Counter()
    self.collective_counts = collections.Counter()
    self.by_op: dict[str, list[int]] = collections.defaultdict(
        lambda: [0, 0, 0])
    self.live = 0
    self.peak = 0

  def _free(self, n: int) -> None:
    self.live -= n

  def __torch_dispatch__(self, func, types, args=(), kwargs=None):
    kwargs = kwargs or {}
    if (func is torch.ops.aten._local_scalar_dense.default
        and args[0].dtype == torch.bool):
      return True
    # Only the ops the program calls: not those that faking an op runs
    # inside it (a decomposition on a cache miss of the fake mode).
    self._depth += 1
    try:
      out = super().__torch_dispatch__(func, types, args, kwargs)
    finally:
      self._depth -= 1
    if out is NotImplemented or self._depth:
      return out
    ins = _tensors((args, kwargs))
    if not any(isinstance(t, DTensor) for t in ins):
      self._count(func, ins, args, kwargs, out)
    return out

  def _count(self, func, ins, args, kwargs, out) -> None:
    name = func._schema.name
    ns, _, op = name.partition("::")
    times = getattr(_REPEAT, "n", 1)
    row = self.by_op[str(func)]
    row[0] += times
    if ns == "_c10d_functional" and op in COLLECTIVES:
      n = _nbytes(ins[0]) * times
      self.collectives[COLLECTIVES[op]] += n
      self.collective_counts[COLLECTIVES[op]] += times
      row[2] += n
      return
    if name in _FREE or func.is_view:
      return
    outs = _tensors(out)
    n = (sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)) * times
    self.hbm_bytes += n
    row[2] += n
    packet = func._overloadpacket
    f = None
    if name == "repro_torch::flash_attention":
      f = _fa.attention_flops(*args, **kwargs)
    elif packet in flop_registry:
      f = int(flop_registry[packet](*args, **kwargs, out_val=out))
    if f is not None:
      self.flops += f * times
      row[1] += f * times
    fresh = [t for t in outs if all(t is not i for i in ins)]
    for t in fresh:
      k = _nbytes(t)
      self.live += k
      weakref.finalize(t, self._free, k)
    self.peak = max(self.peak, self.live)

  def analyze(self) -> dict:
    """The reference's ``analyze_text`` keys, per device, and the counts
    of each collective and the traced peak."""
    return {
        "flops_per_device": self.flops,
        "hbm_bytes_per_device": self.hbm_bytes,
        "collective_bytes_per_device": sum(self.collectives.values()),
        "collectives_by_type": dict(self.collectives),
        "collective_counts": dict(self.collective_counts),
        "traced_peak_bytes": self.peak,
        "notes": ["per-device counts of the ops one rank runs, traced "
                  "eagerly on fake tensors: memory bytes are operands plus "
                  "results of every op that is not a view (no fusion)"],
    }

  def op_table(self) -> list[dict]:
    """Per op: calls, FLOPs and bytes (memory, or a collective's operand
    bytes), the most bytes first."""
    rows = [{"op": op, "calls": c, "flops": f, "bytes": b}
            for op, (c, f, b) in self.by_op.items()]
    return sorted(rows, key=lambda r: (-r["bytes"], -r["flops"]))
