"""Seeded random weights, made by the benchmark and handed to both sides.

The program and the reference get the same values: the program takes the
tensors built here (its modules wrap them, no copy); the reference builds
them again from the seed after the window, one group at a time (the head
group, then each layer), in float32.  Each group has a generator of its
own, seeded from (seed, group), and draws its leaves in one fixed order
directly on the device in the dtype they are served in, so rebuilding one
group replays exactly its draws.  The layout is the port's parameter
tree: {"embed": {"table"}, "lm_head": {"w"}, "final_norm": {"scale"},
"layers": [{"norm1", "norm2", "mla" or "attn", "ffn"}]}.  Scales are the
usual fan-in ones (1/sqrt(fan-in); the embedding 0.02); norm scales are 1.
"""

from __future__ import annotations

import math

import torch

_GOLDEN = 0x9E3779B97F4A7C15


def group_seed(seed: int, group: int) -> int:
  """A 63-bit generator seed for one group of one run's weights."""
  return (seed * _GOLDEN + 0x632BE59BD9B4E019 * (group + 1)) % (2 ** 63)


def _leaves(model: dict, group: int) -> list:
  """(path, shape, scale, dtype) of the random leaves of ``group`` (0: the
  embedding and the head; i + 1: layer i), in drawing order; scale None is
  a norm scale of ones (f32, drawn from nothing)."""
  d, v = model["d_model"], model["vocab"]
  dt = getattr(torch, model["dtype"])
  f32 = torch.float32
  if group == 0:
    return [(("embed", "table"), (v, d), 0.02, dt),
            (("lm_head", "w"), (d, v), 1 / math.sqrt(d), dt),
            (("final_norm", "scale"), (d,), None, f32)]
  e, f = model["experts"], model["expert_width"]
  h = model["heads"]
  out = [(("norm1", "scale"), (d,), None, f32),
         (("norm2", "scale"), (d,), None, f32),
         (("ffn", "router"), (d, e), 1 / math.sqrt(d), f32),
         (("ffn", "we_in"), (e, d, f), 1 / math.sqrt(d), dt),
         (("ffn", "we_gate"), (e, d, f), 1 / math.sqrt(d), dt),
         (("ffn", "we_out"), (e, f, d), 1 / math.sqrt(f), dt)]
  if model["shared_experts"]:
    fs = f * model["shared_experts"]
    out += [(("ffn", "shared", "w_in"), (d, fs), 1 / math.sqrt(d), dt),
            (("ffn", "shared", "w_gate"), (d, fs), 1 / math.sqrt(d), dt),
            (("ffn", "shared", "w_out"), (fs, d), 1 / math.sqrt(fs), dt)]
  if model["kind"] == "mla_moe":
    r, nd, rd, vd = (model["kv_lora_rank"], model["qk_nope_dim"],
                     model["qk_rope_dim"], model["v_head_dim"])
    out += [(("mla", "wq"), (d, h, nd + rd), 1 / math.sqrt(d), dt),
            (("mla", "w_dkv"), (d, r + rd), 1 / math.sqrt(d), dt),
            (("mla", "w_uk"), (r, h, nd), 1 / math.sqrt(r), dt),
            (("mla", "w_uv"), (r, h, vd), 1 / math.sqrt(r), dt),
            (("mla", "wo"), (h, vd, d), 1 / math.sqrt(h * vd), dt)]
  else:
    hkv, dh = model["kv_heads"], model["head_dim"]
    out += [(("attn", "wq"), (d, h, dh), 1 / math.sqrt(d), dt),
            (("attn", "wk"), (d, hkv, dh), 1 / math.sqrt(d), dt),
            (("attn", "wv"), (d, hkv, dh), 1 / math.sqrt(d), dt),
            (("attn", "wo"), (h, dh, d), 1 / math.sqrt(h * dh), dt)]
  return out


def build_group(model: dict, seed: int, group: int, device,
                dtype: torch.dtype | None = None) -> dict:
  """One group's leaves as a nested dict, drawn on ``device``; with
  ``dtype`` each leaf is cast to it after drawing (the reference's f32)."""
  gen = torch.Generator(device=device)
  gen.manual_seed(group_seed(seed, group))
  tree: dict = {}
  for path, shape, scale, dt in _leaves(model, group):
    if scale is None:
      t = torch.ones(shape, dtype=dt, device=device)
    else:
      t = torch.randn(shape, generator=gen, dtype=dt, device=device)
      t.mul_(scale)
    if dtype is not None:
      t = t.to(dtype)
    node = tree
    for key in path[:-1]:
      node = node.setdefault(key, {})
    node[path[-1]] = t
  return tree


def build_params(model: dict, seed: int, device) -> dict:
  """Every group: the port's parameter tree in the served dtype."""
  params = build_group(model, seed, 0, device)
  params["layers"] = [build_group(model, seed, i + 1, device)
                      for i in range(model["layers"])]
  return params


def param_count(model: dict) -> int:
  n = sum(math.prod(s) for _, s, _, _ in _leaves(model, 0))
  return n + model["layers"] * sum(math.prod(s)
                                   for _, s, _, _ in _leaves(model, 1))


def group_prefix(group: int) -> str:
  """The start of a group's parameter names in the port's
  ``named_parameters`` (a layer's leaves sit under ``layers.<i>.params``)."""
  return "" if group == 0 else f"layers.{group - 1}.params."


def named(tree: dict, prefix: str = "") -> dict:
  """A nested dict's leaves by dotted name."""
  out = {}
  for k, v in tree.items():
    if isinstance(v, dict):
      out.update(named(v, f"{prefix}{k}."))
    else:
      out[prefix + k] = v
  return out
