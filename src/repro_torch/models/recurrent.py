"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).

Counterpart of ``repro.models.recurrent``, as plain functions on tensors
(parameters are dicts in the JAX layouts: ``w_x`` (d, L), ``conv_w``
(W, L), ``a_param`` (L,) f32, ...):

  y = W_out( GeLU(W_gate x) * RGLRU(conv1d(W_x x)) )
  r_t = sigmoid(W_r x_t);  i_t = sigmoid(W_i x_t)
  log a_t = -c * softplus(Lambda) * r_t           (c = 8)
  h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)

Over a sequence the linear recurrence runs as a log-depth parallel prefix
(``linear_scan``: Hillis-Steele, log2(S) shifted multiply-adds in f32),
where the reference runs ``lax.associative_scan`` with the same combine
(a1 * a2, a2 * b1 + b2); the sums associate otherwise, so the two agree
to f32 rounding.  The reference writes no kernel for the block (it is XLA
ops there too), so the port's is PyTorch ops.  Dtypes follow the
reference: the projections, the conv and the gate product in the
activation dtype, ``a`` and the gated input in f32, ``h`` cast back to the
activation dtype before ``gate * h``.  Decode keeps the state {h (B, L)
f32, conv (B, W - 1, L) f32: the last W - 1 conv inputs} and updates it in
place, as the attention layers update their caches.  The reference's
``shard_activation`` calls stand at its points (the identity without
sharding rules).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.sharding import local as _local
from repro_torch.sharding.local import assign, einsum
from repro_torch.sharding.specs import shard_activation

Params = dict[str, torch.Tensor]

_C = 8.0


def rg_init(cfg, gen: torch.Generator, dtype, device) -> Params:
  """The block's weights with the reference's distributions, drawn in its
  order (u, w_x, w_gate, w_out, gate_w_r, gate_w_i, conv_w): Lambda =
  softplus^-1(-log(u) / c) with u ~ U(0.9, 0.999), kept in f32, so that
  a = u^r; the matrices N(0, 1) / sqrt(fan-in), the conv taps N(0, 1) /
  sqrt(W)."""
  d, l = cfg.d_model, cfg.lru_width or cfg.d_model
  si, sl = 1.0 / math.sqrt(d), 1.0 / math.sqrt(l)
  u = torch.rand((l,), generator=gen, dtype=torch.float32, device=device)
  u = u * (0.999 - 0.9) + 0.9
  a_param = torch.log(torch.expm1(-torch.log(u) / _C))

  def normal(shape, scale):
    return torch.randn(shape, generator=gen, dtype=dtype,
                       device=device).mul_(scale)

  return {"w_x": normal((d, l), si),
          "w_gate": normal((d, l), si),
          "w_out": normal((l, d), sl),
          "a_param": a_param,
          "gate_w_r": normal((d, l), si),
          "gate_w_i": normal((d, l), si),
          "conv_w": normal((cfg.conv_width, l),
                           1.0 / math.sqrt(cfg.conv_width))}


def _conv1d_causal(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
  """Depthwise causal conv, x (B, S, L), w (W, L), in x's dtype: the
  reference's tap sum, tap W - 1 on the current position first, then the
  taps on positions 1 .. W - 1 back (zeros before the sequence)."""
  if isinstance(x, DTensor):
    return _conv_on_blocks(x, w)
  width = w.shape[0]
  out = x * w[width - 1]
  for i in range(1, width):
    shifted = F.pad(x, (0, 0, i, 0))[:, :-i]
    out = out + shifted * w[width - 1 - i]
  return out


def _conv_on_blocks(x: DTensor, w: torch.Tensor) -> DTensor:
  """``_conv1d_causal`` on each rank's block of x (B, S, L): the batch and
  the channels L split where x has them, the sequence whole, with the
  block's channels of w (W, L), whose gradient is then partial."""
  mesh = x.device_mesh
  want = _local.keep_placements(x, (0, 2))
  x = _local.to_placements(x, want)
  lo, hi = _local.shard_range(x, 2)
  if isinstance(w, DTensor):
    grad = tuple(Partial() if isinstance(p, Shard) else Replicate()
                 for p in want)
    w = _local.to_placements(w, (Replicate(),) * mesh.ndim).to_local(
        grad_placements=grad)
  out = _conv1d_causal(x.to_local(), w[:, lo:hi])
  return _local.wrap(out, mesh, want)


def _rglru_gates(p: Params, x_raw: torch.Tensor, u: torch.Tensor):
  """(a, gated), both f32: the recurrence's decay and its input, from the
  pre-conv input ``x_raw`` (the gates) and the conv output ``u``."""
  r = torch.sigmoid(einsum("...d,dl->...l", x_raw,
                                 p["gate_w_r"]).to(torch.float32))
  i = torch.sigmoid(einsum("...d,dl->...l", x_raw,
                                 p["gate_w_i"]).to(torch.float32))
  log_a = -_C * F.softplus(p["a_param"]) * r
  a = torch.exp(log_a)
  gated = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), 1e-9, 1.0)) * (
      i * u.to(torch.float32))
  return a, gated


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """h_t = a_t h_{t-1} + b_t along axis 1 from h_{-1} = 0, as a log-depth
  parallel prefix (Hillis-Steele): at offset d = 1, 2, 4, ... each
  position t >= d takes the combine of (a, b) at t - d and at t,
  (a_{t-d} a_t, a_t b_{t-d} + b_t), in ceil(log2 S) passes of whole-tensor
  ops.  Out of place, so autograd differentiates it."""
  s, d = a.shape[1], 1
  while d < s:
    b = torch.cat([b[:, :d], torch.addcmul(b[:, d:], a[:, d:], b[:, :-d])],
                  dim=1)
    if 2 * d < s:
      a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
    d *= 2
  return b


def rg_apply_seq(p: Params, x: torch.Tensor, cfg, *,
                 return_state: bool = False):
  """The block over a sequence, x (B, S, d) -> (B, S, d) [, the decode
  state after the last position: h (B, L) (cast to x's dtype and back, as
  the reference keeps it) and the last W - 1 conv inputs (B, W - 1, L), f32,
  zeros where the sequence is shorter]."""
  xb = einsum("bsd,dl->bsl", x, p["w_x"])
  gate = F.gelu(einsum("bsd,dl->bsl", x, p["w_gate"]),
                approximate="tanh")
  u = _conv1d_causal(xb, p["conv_w"])
  a, gated = _rglru_gates(p, x, u)
  h = shard_activation(linear_scan(a, gated).to(x.dtype), "residual")
  y = einsum("bsl,ld->bsd", gate * h.to(gate.dtype), p["w_out"])
  if not return_state:
    return y
  keep = cfg.conv_width - 1
  conv = xb[:, max(xb.shape[1] - keep, 0):].to(torch.float32)
  if conv.shape[1] < keep:
    conv = F.pad(conv, (0, 0, keep - conv.shape[1], 0))
  return y, {"h": h[:, -1].to(torch.float32), "conv": conv}


def rg_init_state(cfg, batch: int, device=None) -> Params:
  """The zero state: h (B, L) and conv (B, W - 1, L), f32."""
  l = cfg.lru_width or cfg.d_model
  return {"h": torch.zeros((batch, l), dtype=torch.float32, device=device),
          "conv": torch.zeros((batch, cfg.conv_width - 1, l),
                              dtype=torch.float32, device=device)}


def rg_apply_decode(p: Params, x: torch.Tensor, state: Params, cfg):
  """One token, x (B, d).  Returns (y (B, d), state), the state written in
  place: the conv over the f32 history (the state's W - 1 inputs and this
  one) with f32 taps, h in f32, and gate * h cast to x's dtype before
  ``w_out``, as in the reference."""
  xb = einsum("bd,dl->bl", x, p["w_x"])
  gate = F.gelu(einsum("bd,dl->bl", x, p["w_gate"]),
                approximate="tanh")
  hist = torch.cat([state["conv"], xb[:, None].to(torch.float32)], dim=1)
  u = einsum("bwl,wl->bl", hist, p["conv_w"].to(torch.float32))
  a, gated = _rglru_gates(p, x, u)
  h = shard_activation(a * state["h"] + gated, "rg_state")
  y = einsum("bl,ld->bd", (gate.to(torch.float32) * h).to(x.dtype),
                   p["w_out"])
  assign(state["h"], h)
  assign(state["conv"], hist[:, 1:])
  return y, state
