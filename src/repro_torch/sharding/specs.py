"""Sharding rules: parameter, cache, batch and optimizer-state specs, and
activation constraints, on a ``DeviceMesh``.

Counterpart of ``repro.sharding.specs``, rule for rule.  A spec is a tuple
with one entry per tensor dimension: ``None`` (replicated), a mesh axis
name, or a tuple of names (the dimension split over their product, the
first name outermost) -- ``PartitionSpec``'s meaning, in the port's own
small type.  ``placements(mesh, spec)`` turns one into DTensor placements,
one ``Shard(d)`` or ``Replicate()`` per mesh dimension.

Rules are divisibility-aware: a rule names the preferred axes of each
dimension, and axes whose product does not divide it fall back to a
prefix of them, or to replication (recurrentgemma's 10 attention heads or
xlstm's 4 cannot shard over a 16-way model axis, so those shard head_dim
or features instead).  No axis is used twice in one spec.

The port keeps one module per layer (``models/convert.py::split_layers``),
so its leaves have no leading ``reps`` dimension to pad: the rules match
the same ``group/leaf`` tails on the port's parameter names (dots read as
slashes: ``layers.3.params.attn.wq`` is ``layers/3/params/attn/wq``).

Activation constraints are applied through a context, so the same model
code runs unannotated (``shard_activation`` returns its argument) and,
under ``use_rules(rules)``, redistributes each named activation to its
rule's placements.  ``use_rules`` also enters DTensor's
``implicit_replication``: the tensors a model builds itself (positions,
RoPE's angles, causal and window masks, zeroed accumulators, initial
recurrent states) are then taken as replicated, which is sound because
every rank builds the same values from the same shapes and integers.
"""

from __future__ import annotations

import contextlib
import dataclasses
import re
import threading
from typing import Any

import torch
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.experimental import implicit_replication

Spec = tuple

_STATE = threading.local()


def axis_names(mesh) -> tuple[str, ...]:
  """The mesh's axis names: a ``DeviceMesh``'s ``mesh_dim_names``, or a
  stand-in's ``axis_names``."""
  names = getattr(mesh, "mesh_dim_names", None)
  return tuple(names if names is not None else mesh.axis_names)


def axis_size(mesh, name: str) -> int:
  """One axis's size, read through one accessor: a ``DeviceMesh``'s shape
  is a tuple in axis order, a stand-in's a dict by name."""
  shape = mesh.shape
  if isinstance(shape, dict):
    return shape[name]
  return tuple(shape)[axis_names(mesh).index(name)]


def _names(entry) -> tuple[str, ...]:
  if entry is None:
    return ()
  return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclasses.dataclass
class ShardingRules:
  mesh: Any
  data_axes: tuple[str, ...] = ("data",)    # ("pod", "data") multi-pod
  model_axis: str = "model"
  seq_shard_activations: bool = False
  fsdp: bool = False

  def axis_size(self, name: str) -> int:
    return axis_size(self.mesh, name)

  def _fit(self, dim: int, axes, used: set[str] | None = None):
    """Axes (or their longest prefix) whose product divides ``dim``, else
    None; axes already taken by earlier dimensions of the spec are
    skipped.  A dimension of size 1 is never split: only axes of size 1
    divide it, where splitting and replicating hold the same data, and
    DTensor's view rules drop a split singleton dimension."""
    if axes is None or dim == 1:
      return None
    axes = _names(axes)
    if used is not None:
      axes = tuple(a for a in axes if a not in used)
    for cut in range(len(axes), 0, -1):
      sub = axes[:cut]
      t = 1
      for a in sub:
        t *= self.axis_size(a)
      if dim % t == 0:
        return sub if len(sub) > 1 else sub[0]
    return None

  def spec(self, shape, wanted) -> Spec:
    if len(shape) != len(wanted):
      raise ValueError(f"shape {tuple(shape)} and wanted axes {wanted} "
                       "differ in rank")
    used: set[str] = set()
    parts = []
    for d, a in zip(shape, wanted):
      fit = self._fit(d, a, used)
      parts.append(fit)
      used.update(_names(fit))
    return tuple(parts)

  @property
  def dp(self):
    return self.data_axes if len(self.data_axes) > 1 else self.data_axes[0]

  @property
  def tp(self):
    return self.model_axis


# Parameter rules: (path regex, wanted axes per dim).  First match wins.
# DP and TP resolve against the live rules; FSDP to DP when rules.fsdp,
# else None; ALL to every mesh axis (data axes + model).
DP, TP, FSDP = "__DP__", "__TP__", "__FSDP__"
ALL = "__ALL__"
MOE_FF = "__MOE_FF__"

PARAM_RULES: list[tuple[str, tuple[Any, ...] | None]] = [
    (r".*embed/table$", (TP, FSDP)),               # (vocab, d)
    (r".*lm_head/w$", (FSDP, TP)),                 # (d, vocab)
    (r".*codebook_head_\d+/w$", (FSDP, TP)),       # (d, codebook_vocab)
    (r".*attn/wq$", (FSDP, TP, None)),             # (d, H, Dh)
    (r".*attn/wk$", (FSDP, TP, None)),
    (r".*attn/wv$", (FSDP, TP, None)),
    (r".*attn/wo$", (TP, None, FSDP)),             # (H, Dh, d)
    (r".*mla/wq$", (FSDP, TP, None)),              # (d, H, nope+rope)
    (r".*mla/w_dkv$", (FSDP, None)),               # (d, r+rope)
    (r".*mla/w_uk$", (None, TP, None)),            # (r, H, nope)
    (r".*mla/w_uv$", (None, TP, None)),            # (r, H, v)
    (r".*mla/wo$", (TP, None, FSDP)),              # (H, v, d)
    (r".*ffn/router$", None),                      # (d, E) replicated
    (r".*ffn/we_in$", (TP, FSDP, MOE_FF)),         # (E, d, f): EP over model
    (r".*ffn/we_gate$", (TP, FSDP, MOE_FF)),
    (r".*ffn/we_out$", (TP, MOE_FF, FSDP)),        # (E, f, d)
    (r".*ffn/(shared/)?w_in$", (FSDP, TP)),        # (d, f) dense/shared MLP
    (r".*ffn/(shared/)?w_gate$", (FSDP, TP)),
    (r".*ffn/(shared/)?w_out$", (TP, FSDP)),       # (f, d)
    (r".*rg/(w_x|w_gate)$", (FSDP, TP)),           # (d, lru)
    (r".*rg/w_out$", (TP, FSDP)),                  # (lru, d)
    (r".*rg/(a_param|conv_w.*|gate_w.*|gate_b.*)", None),  # small
    (r".*lstm/w_(q|k|v)$", (FSDP, None, TP)),      # (d, H, dh): shard dh
    (r".*lstm/.*", None),
    (r".*(norm|scale|bias).*", None),
]


def _resolve(rules: ShardingRules, wanted) -> tuple:
  out = []
  for a in wanted:
    if a == DP:
      out.append(rules.data_axes)
    elif a == TP or a == MOE_FF:
      # MOE_FF: the expert FFN dim takes model only where the expert dim
      # could not (``param_spec`` drops the second use).
      out.append(rules.model_axis)
    elif a == FSDP:
      out.append(rules.data_axes if rules.fsdp else None)
    elif a == ALL:
      out.append(rules.data_axes + (rules.model_axis,))
    else:
      out.append(a)
  return tuple(out)


def param_path(name: str) -> str:
  """A port parameter name as a rule path: ``layers.3.params.attn.wq`` ->
  ``layers/3/params/attn/wq``."""
  return name.replace(".", "/")


def param_spec(rules: ShardingRules, path: str, shape) -> Spec:
  replicated = (None,) * len(shape)
  for pat, wanted in PARAM_RULES:
    if re.match(pat, path):
      if wanted is None:
        return replicated
      resolved = _resolve(rules, wanted)
      if len(shape) != len(resolved):
        return replicated
      parts = list(rules.spec(shape, resolved))
      seen: set[str] = set()
      for i, s in enumerate(parts):
        names = _names(s)
        if any(n in seen for n in names):
          parts[i] = None
        seen.update(names)
      return tuple(parts)
  return replicated


def param_specs_tree(rules: ShardingRules, model) -> dict[str, Spec]:
  """{parameter name: spec} over ``model.named_parameters()``."""
  return {name: param_spec(rules, param_path(name), tuple(p.shape))
          for name, p in model.named_parameters()}


# Decode-cache rules: (leaf-name regex, ndim, wanted axes), on one layer's
# cache dict (the reference's leaves without their leading reps dim).
CACHE_RULES: list[tuple[str, int, tuple[Any, ...]]] = [
    # attn KV (B, S, H, D): batch over data, sequence over whatever is left
    # (long_500k's global batch of 1: S takes ALL 512 ways).
    (r"(k|v)$", 4, (DP, ALL, None, None)),
    (r"c_kv$", 3, (DP, ALL, None)),               # MLA latent (B, S, r)
    (r"k_rope$", 3, (DP, ALL, None)),
    (r"h$", 2, (DP, TP)),                         # rg-lru state (B, L)
    (r"conv$", 3, (DP, None, TP)),                # rg conv hist (B, W, L)
    (r"c$", 4, (DP, None, None, TP)),             # mlstm C (B, H, dk, dv)
    (r"(c|n|m|h)$", 3, (DP, None, TP)),           # per-head vec states
    (r"m$", 2, (DP, None)),                       # mlstm stabilizer (B, H)
]


def cache_spec(rules: ShardingRules, leaf: str, shape) -> Spec:
  # Attention KV (B, S, H, D): shard heads where the kv-head count takes
  # the model axis (attention stays local to a device); else shard the
  # sequence.
  if len(shape) == 4 and re.search(r"(k|v)$", leaf):
    if shape[2] % rules.axis_size(rules.model_axis) == 0:
      return rules.spec(shape, _resolve(rules, (DP, None, TP, None)))
    return rules.spec(shape, _resolve(rules, (DP, ALL, None, None)))
  for pat, ndim, wanted in CACHE_RULES:
    if len(shape) == ndim and re.search(pat, leaf):
      return rules.spec(shape, _resolve(rules, wanted))
  return (None,) * len(shape)


def cache_specs_tree(rules: ShardingRules, caches: list[dict]) -> list[dict]:
  """One {leaf: spec} per layer of ``init_cache``'s list."""
  return [{leaf: cache_spec(rules, leaf, tuple(t.shape))
           for leaf, t in layer.items()} for layer in caches]


def batch_spec(rules: ShardingRules, shape) -> Spec:
  """The leading (batch) dim over the data axes, the rest replicated."""
  return rules.spec(shape, (rules.data_axes,) + (None,) * (len(shape) - 1))


def batch_specs_tree(rules: ShardingRules, batch: dict) -> dict[str, Spec]:
  return {k: batch_spec(rules, tuple(v.shape)) for k, v in batch.items()}


def opt_state_specs_tree(rules: ShardingRules, opt_state: dict,
                         param_specs: dict[str, Spec]) -> dict:
  """AdamW's moments mirror the parameter specs (as does the error
  feedback residual); the step and the norm history are replicated."""
  out = {}
  for k, v in opt_state.items():
    if k == "adam":
      adam = {}
      for name, leaf in v.items():
        if name in ("m", "v"):
          adam[name] = dict(param_specs)
        else:
          adam[name] = (None,) * leaf.dim()
      out[k] = adam
    elif k == "ef_residual":
      out[k] = dict(param_specs)
    else:
      out[k] = _replicated_tree(v)
  return out


def _replicated_tree(tree):
  if isinstance(tree, dict):
    return {k: _replicated_tree(v) for k, v in tree.items()}
  return (None,) * tree.dim()


# ---------------------------------------------------------------------------
# Specs as DTensor placements.
# ---------------------------------------------------------------------------


def placements(mesh, spec: Spec) -> tuple:
  """One placement per mesh dimension: ``Shard(d)`` on every mesh axis
  that tensor dimension d is split over, ``Replicate()`` on the rest.  A
  dimension over several axes is split over them in mesh order, which is
  the spec's order only when its names are in mesh order: asserted."""
  names = axis_names(mesh)
  out = [Replicate()] * len(names)
  for d, entry in enumerate(spec):
    axes = _names(entry)
    idx = [names.index(a) for a in axes]
    if idx != sorted(idx):
      raise ValueError(f"spec {spec}: dimension {d} is split over {axes}, "
                       f"not in the mesh's order {names}")
    for i in idx:
      if not isinstance(out[i], Replicate):
        raise ValueError(f"spec {spec} uses mesh axis {names[i]!r} twice")
      out[i] = Shard(d)
  return tuple(out)


def distribute(t: torch.Tensor, mesh, spec: Spec) -> DTensor:
  """``t`` (the full tensor, the same on every rank) on the mesh by
  ``spec``; each rank keeps its block, no collective."""
  return distribute_tensor(t, mesh, placements(mesh, spec),
                           src_data_rank=None)


def distribute_tree(tree, mesh, specs):
  """A nested dict (or list) of tensors distributed leaf by leaf by the
  matching tree of specs."""
  if isinstance(tree, dict):
    return {k: distribute_tree(v, mesh, specs[k]) for k, v in tree.items()}
  if isinstance(tree, list):
    return [distribute_tree(v, mesh, s) for v, s in zip(tree, specs)]
  return distribute(tree, mesh, specs)


def distribute_model(model: torch.nn.Module, mesh,
                     specs: dict[str, Spec]) -> torch.nn.Module:
  """Replace every parameter of ``model`` by its DTensor under ``specs``
  (``param_specs_tree``), in place, keeping ``requires_grad``."""
  for name, p in list(model.named_parameters()):
    owner_name, _, leaf = name.rpartition(".")
    owner = model.get_submodule(owner_name) if owner_name else model
    dt = distribute(p.detach(), mesh, specs[name])
    owner.register_parameter(
        leaf, torch.nn.Parameter(dt, requires_grad=p.requires_grad))
  return model


# ---------------------------------------------------------------------------
# Activation constraints (context-scoped).
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def use_rules(rules: ShardingRules | None):
  """Activate ``rules`` for ``shard_activation``, and, with rules, treat
  the plain tensors the model builds as replicated (see the module's
  docstring)."""
  prev = getattr(_STATE, "rules", None)
  _STATE.rules = rules
  try:
    with implicit_replication() if rules is not None else \
        contextlib.nullcontext():
      yield
  finally:
    _STATE.rules = prev


def current_rules() -> ShardingRules | None:
  return getattr(_STATE, "rules", None)


# Activation kinds -> wanted axes (resolved lazily, divisibility-checked).
_ACT_RULES: dict[str, tuple[Any, ...]] = {
    "moe_groups": (DP, None, None),            # (G, gs, d): groups over DP
    "moe_router": (DP, TP, None),              # (G, gs, E): per-token math
    "moe_groups4": (DP, TP, None, None),       # (G, E, cap, d)
    "residual": (DP, "__SEQ__", None),         # (B, S, d)
    "residual_decode": (DP, None),             # (B, d)
    "heads": (DP, None, TP, None),             # (B, S, H, Dh)
    "heads_decode": (DP, TP, None),            # (B, H, Dh)
    "kv_cache": (DP, TP, None, None),          # (B, S, Hkv, Dh): seq-shard
    "kv_cache_batch": (DP, None, None, None),  # alt: batch-only
    "logits": (DP, None, TP),                  # (B, S, V)
    "logits_decode": (DP, TP),                 # (B, V)
    "expert_acts": (TP, None, None),           # (E, cap, d)
    "expert_acts4": (DP, TP, None, None),      # (G, E, cap, d)
    "ffn": (DP, None, TP),                     # (B, S, f)
    "rg_state": (DP, TP),                      # (B, lru)
    "mlstm_state": (DP, None, None, TP),       # (B, H, dk, dv)
    "tokens": (DP, None),                      # (B, S)
}


def activation_spec(rules: ShardingRules, kind: str, shape) -> Spec | None:
  """The spec of activation ``kind`` at ``shape`` under ``rules``, or None
  where the rule's rank differs from the tensor's (left alone)."""
  wanted = list(_resolve(rules, _ACT_RULES[kind]))
  for i, a in enumerate(wanted):
    if a == "__SEQ__":
      wanted[i] = rules.model_axis if rules.seq_shard_activations else None
  if len(wanted) != len(shape):
    return None
  return rules.spec(shape, tuple(wanted))


def shard_activation(x: torch.Tensor, kind: str) -> torch.Tensor:
  """Redistribute DTensor ``x`` to activation ``kind``'s placements when
  rules are active; otherwise (no rules, a plain tensor, or a rank the
  rule does not fit) return ``x`` itself."""
  rules = current_rules()
  if rules is None or not isinstance(x, DTensor):
    return x
  spec = activation_spec(rules, kind, tuple(x.shape))
  if spec is None:
    return x
  want = placements(x.device_mesh, spec)
  if tuple(x.placements) == want:
    return x
  return x.redistribute(x.device_mesh, want)
