"""Mixture-of-Experts FFN with the paper's soft top-k router.

Counterpart of ``repro.models.moe``.  Two routers (``cfg.router``):

``softmax_topk``
    The baseline (the reference's ``ArchConfig`` default): the softmax
    probabilities of the k largest, renormalised; the gradient reaches only
    the selected experts' logits.
``soft_topk``
    The paper's router: the gate mass is the projection of the router
    logits onto the k-subset permutahedron (soft top-k, row sum k), with a
    dense gradient to every expert's logit:

* in serving (no autograd), the fused ``soft_topk_gates``: its CUDA kernel
  on the card, its plain version on the CPU;
* under autograd, ``repro_torch.core.soft_topk_mask`` with its exact
  Lemma 2 backward (on the card its forward is the PAV kernel; the
  reference calls the same operator with its minimax backend, and the
  port's default backend gives the same values).  Remat keeps to one
  route: the trainer's ``torch.utils.checkpoint`` is non-reentrant, so
  the forward and its recompute in backward both run with grad enabled
  and route on the same gates (a reentrant checkpoint would run the
  forward under ``no_grad``, on the fused gates, and near ties could route
  differently in the recompute).

Dispatch stays hard top-k with capacity, as one-hot einsums within groups
of ``moe_group_size`` tokens; the token count is padded to a multiple of
the group size with zero rows, which are routed and take capacity as in
the reference.  The router runs in f32; dispatch and combine are cast to
the activation dtype.  Parameters keep the JAX layouts: ``router`` (d, E)
f32, ``we_in`` / ``we_gate`` (E, d, f), ``we_out`` (E, f, d), ``shared``
(a SwiGLU MLP of width f * num_shared_experts, only where the config has
shared experts); ``moe_init`` draws them with the reference's scales.

``moe_apply`` runs in three spans: ``repro_moe_dispatch`` (the dispatch
mask and the tokens sent to their slots), ``repro_moe_experts`` (the
routed experts' products and SiLU) and ``repro_moe_combine``; while a
profiler records it also counts, on the device, the capacity slots it
offered and those a token took (``moe_slots``, ``moe_slots_filled``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.core.operators import soft_topk_mask
from repro_torch.kernels import soft_topk as _st
from repro_torch.models.layers import Params, mlp_apply, normal
from repro_torch.obs import metrics
from repro_torch.obs.tracing import recording, span
from repro_torch.sharding import local as _local
from repro_torch.sharding.local import einsum
from repro_torch.sharding.specs import shard_activation

ROUTERS = ("softmax_topk", "soft_topk")


def moe_init(cfg, gen: torch.Generator, dtype, device) -> Params:
  """router (f32), we_in, we_gate, we_out, then the shared experts'
  w_in, w_gate, w_out where ``num_shared_experts``, drawn in that order:
  1/sqrt(d) in, 1/sqrt(f) out, as the reference's ``moe_init``."""
  d, f, e = cfg.d_model, cfg.moe_d_ff or cfg.d_ff, cfg.num_experts
  si, so = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
  p = {"router": normal(gen, (d, e), si, torch.float32, device),
       "we_in": normal(gen, (e, d, f), si, dtype, device),
       "we_gate": normal(gen, (e, d, f), si, dtype, device),
       "we_out": normal(gen, (e, f, d), so, dtype, device)}
  if cfg.num_shared_experts:
    fs = f * cfg.num_shared_experts
    p["shared"] = {"w_in": normal(gen, (d, fs), si, dtype, device),
                   "w_gate": normal(gen, (d, fs), si, dtype, device),
                   "w_out": normal(gen, (fs, d), so, dtype, device)}
  return p


def _gates(logits: torch.Tensor, k: int, eps: float) -> torch.Tensor:
  """The fused gates of (..., E) logits, a row a token."""
  e = logits.shape[-1]
  return _st.soft_topk_gates(logits.reshape(-1, e), k, eps).reshape(
      logits.shape)


def _router_weights(cfg, logits: torch.Tensor):
  """logits: (..., E) f32 -> (combine weights, router probs)."""
  if cfg.router not in ROUTERS:
    raise ValueError(f"router must be one of {ROUTERS}, got {cfg.router!r}")
  k = cfg.experts_per_token
  probs = torch.softmax(logits, dim=-1)
  if cfg.router == "softmax_topk":
    # Every expert whose probability reaches the k-th largest (ties kept).
    topv = torch.topk(probs, k, dim=-1).values
    w = torch.where(probs >= topv[..., -1:], probs, 0.0)
    w = w / torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-9)
    return w, probs
  if torch.is_grad_enabled() and logits.requires_grad:
    mask = soft_topk_mask(logits, k, cfg.router_eps)
  elif isinstance(logits, DTensor):
    # Each rank gates its own tokens (flattening two split dims of a
    # DTensor would make a strided split).
    mask = _local.on_rows(_gates, logits, k, cfg.router_eps)
  else:
    mask = _gates(logits, k, cfg.router_eps)
  w = mask * probs
  w = w / torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-9)
  return w, probs


def _dispatch_mask(weights: torch.Tensor, k: int, capacity: int):
  """Capacity-bounded top-k dispatch within groups.

  weights: (G, T, E).  Returns dispatch/combine one-hots (G, T, E, C):
  k rounds, each sending every token to its largest remaining weight
  (the first index among equals) while the expert has room.
  """
  g, t, e = weights.shape
  dt = weights.dtype
  w = weights
  dispatch = torch.zeros((g, t, e, capacity), dtype=dt, device=w.device)
  combine = torch.zeros_like(dispatch)
  fill = torch.zeros((g, e), dtype=torch.int64, device=w.device)
  for _ in range(k):
    idx = torch.argmax(w.detach(), dim=-1)                   # (G, T)
    onehot = F.one_hot(idx, e).to(dt)                        # (G, T, E)
    rank_in_round = torch.cumsum(onehot, dim=1) - onehot
    pos = fill[:, None, :] + rank_in_round.to(torch.int64)
    pos_t = torch.sum(pos * onehot.to(torch.int64), dim=-1)  # (G, T)
    ok = pos_t < capacity
    poh = F.one_hot(torch.where(ok, pos_t, capacity),
                    capacity + 1).to(dt)[..., :capacity]      # (G, T, C)
    d_k = onehot[..., None] * poh[:, :, None, :]             # (G, T, E, C)
    gate = torch.gather(w, -1, idx[..., None])               # (G, T, 1)
    dispatch = dispatch + d_k
    combine = combine + d_k * gate[..., None]
    fill = fill + torch.sum(onehot, dim=1).to(torch.int64)
    w = w * (1.0 - onehot)
  return dispatch, combine


def _count_slots(dispatch: torch.Tensor) -> None:
  """``moe_slots`` += G x E x C of ``dispatch`` (G, T, E, C), and
  ``moe_slots_filled`` += its taken slots, each a one, kept on the
  device.  A DTensor counts its local block."""
  if isinstance(dispatch, DTensor):
    dispatch = dispatch.to_local()
  g, _, e, c = dispatch.shape
  metrics.counter_inc("moe_slots", g * e * c)
  metrics.counter_inc("moe_slots_filled", torch.count_nonzero(dispatch))


def load_balance_loss(probs: torch.Tensor,
                      dispatch: torch.Tensor) -> torch.Tensor:
  """Switch-style auxiliary loss: E * <fraction routed, mean prob>."""
  e = probs.shape[-1]
  frac = torch.mean(torch.sum(dispatch, dim=-1), dim=(0, 1))   # (E,)
  mean_prob = torch.mean(probs, dim=(0, 1))
  return e * torch.sum(frac * mean_prob)


def moe_apply(p: Params, x: torch.Tensor, cfg):
  """x: (B,S,d) or (B,d) -> (same shape, aux_loss scalar)."""
  if isinstance(x, DTensor):
    # The tokens are flattened into groups: only the batch stays split.
    x = _local.to_placements(x, _local.keep_placements(x, (0,)))
  orig_shape = x.shape
  d = x.shape[-1]
  xt = x.reshape(-1, d)
  t_total = xt.shape[0]
  gs = min(cfg.moe_group_size, t_total)
  pad = (-t_total) % gs
  if pad:
    xt = torch.cat([xt, xt.new_zeros((pad, d))], dim=0)
  xg = xt.reshape(-1, gs, d)                                    # (G, gs, d)
  xg = _local.grad_in_place(shard_activation(xg, "moe_groups"))

  logits = einsum("gtd,de->gte", xg.to(torch.float32), p["router"])
  logits = shard_activation(logits, "moe_router")
  weights, probs = _router_weights(cfg, logits)
  # The dispatch takes cumsums within a group: tokens back group-local.
  weights = shard_activation(weights, "moe_groups")
  k, e = cfg.experts_per_token, cfg.num_experts
  capacity = max(int(math.ceil(gs * k * cfg.capacity_factor / e)), 4)
  with span("repro_moe_dispatch"):
    dispatch, combine = _dispatch_mask(weights, k, capacity)
    dispatch = dispatch.to(x.dtype)
    combine = combine.to(x.dtype)
    xe = einsum("gtec,gtd->gecd", dispatch, xg)
    xe = shard_activation(xe, "moe_groups4")
  if recording():
    _count_slots(dispatch)

  with span("repro_moe_experts"):
    h = einsum("gecd,edf->gecf", xe, p["we_in"])
    gg = einsum("gecd,edf->gecf", xe, p["we_gate"])
    h = F.silu(gg) * h
    ye = einsum("gecf,efd->gecd", h, p["we_out"])
    ye = shard_activation(ye, "moe_groups4")
  with span("repro_moe_combine"):
    yt = einsum("gtec,gecd->gtd", combine, ye)
    yt = shard_activation(yt, "moe_groups")

  if "shared" in p:
    yt = yt + mlp_apply(p["shared"], xg, "swiglu")

  aux = load_balance_loss(probs, dispatch.to(torch.float32))
  # grad_in_place: the gradient arrives in the residual's layout (the
  # sequence split), whose flatten DTensor refuses.
  out = _local.grad_in_place(yt.reshape(-1, d)[:t_total].reshape(orig_shape))
  return out, aux
