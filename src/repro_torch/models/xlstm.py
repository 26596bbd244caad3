"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory, parallelizable)
and sLSTM (scalar memory, sequential).

Counterpart of ``repro.models.xlstm``, as plain functions on tensors
(parameters are dicts in the JAX layouts: ``w_q`` (d, h, dh), ``w_i`` (d, h)
f32, ``r`` (h, dh, 4, dh), ...).  The reference writes no kernel for
either block (XLA ops and ``lax.scan`` there), so the port's are PyTorch
ops.

mLSTM over a sequence runs the stabilized parallel form

  logits_{t,j} = F_t - F_j + itilde_j  (j <= t),  F_t = cumsum(log sigmoid(ftilde))
  out_t = sum_j exp(logits_{t,j} - m_t) (q_t . k_j) v_j / max(|den_t|, exp(-m_t))

by query and key blocks with a running max, as the reference does: the
score einsum in the model dtype, taken to f32, the gates and the sums in
f32, the causal mask filled with ``_NEG`` (not -inf, so that a row's first
block, which always holds key 0, sets a finite max).  Blocks wholly above
the diagonal are skipped: they add exactly 0 (their weights are exp(_NEG -
m) = 0 and the rescale exp(m - m) = 1), so the result is the reference's
whatever the chunking.  Decode keeps the state (C (B, H, dh, dh), n (B, H,
dh), m (B, H)) in f32; a prefill folds the sequence into it in one pass.

sLSTM is a scan over time with a hand-written backward
(``SLSTMScan``, the reference's ``_slstm_scan`` ``custom_vjp``): the
forward steps the cell position by position and keeps (h, pre, a, c, n) of
every step; the backward is the reverse recurrence of ``_slstm_scan_bwd``
(the stabilizer m gradient-transparent, the ``n > 1e-6`` guard on dn),
with dL/dr one einsum over the whole sequence after the loop.  The factors
of the backward that need no carry (the gates' activations and their
derivatives) are computed for every position at once before the loop, so
that each step of either loop is about 15 launches on the card.  Decode
states are updated in place, as the attention layers update their caches.
The reference's ``shard_activation`` calls stand at its points (the
identity without sharding rules); on DTensors the sLSTM scan runs on each
rank's heads and batch rows (``_slstm_scan``).
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.obs.tracing import span
from repro_torch.sharding import local as _local
from repro_torch.sharding.local import assign, einsum
from repro_torch.sharding.specs import shard_activation

Params = dict[str, torch.Tensor]

_NEG = -1e30
_EPS_N = 1e-6


def _normal(gen, shape, scale, dtype, device) -> torch.Tensor:
  return torch.randn(shape, generator=gen, dtype=dtype,
                     device=device).mul_(scale)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def mlstm_init(cfg, gen: torch.Generator, dtype, device) -> Params:
  """The block's weights with the reference's scales, drawn in its order
  (w_q, w_k, w_v, w_i, w_f, w_o, w_out): the projections N(0, 1) /
  sqrt(d) in ``dtype``, the gate weights in f32, ``b_f`` = 3 (forget gates
  open at init), ``w_out`` N(0, 1) / sqrt(h dh)."""
  d, h, dh = cfg.d_model, cfg.num_heads, cfg.head_dim
  si = 1.0 / math.sqrt(d)
  f32 = torch.float32
  p = {name: _normal(gen, shape, si, dt, device) for name, shape, dt in (
      ("w_q", (d, h, dh), dtype), ("w_k", (d, h, dh), dtype),
      ("w_v", (d, h, dh), dtype), ("w_i", (d, h), f32),
      ("w_f", (d, h), f32), ("w_o", (d, h, dh), dtype))}
  p["b_f"] = torch.full((h,), 3.0, dtype=f32, device=device)
  p["w_out"] = _normal(gen, (h, dh, d), 1.0 / math.sqrt(h * dh), dtype,
                       device)
  return p


def _chunk(size: int, s: int) -> int:
  """The largest divisor of ``s`` not above ``size`` (the reference's)."""
  c = min(size, s)
  while s % c:
    c -= 1
  return c


def _mlstm_gates(p: Params, x: torch.Tensor):
  """(i (..., H), F = cumsum of log sigmoid(f) over the sequence axis or
  log sigmoid(f) for one token), both f32."""
  xf = x.to(torch.float32)
  i_t = einsum("...d,dh->...h", xf, p["w_i"])
  f_t = einsum("...d,dh->...h", xf, p["w_f"]) + p["b_f"]
  return i_t, _local.elementwise(F.logsigmoid, f_t)


def mlstm_apply_seq(p: Params, x: torch.Tensor, cfg, *,
                    return_state: bool = False):
  """Stabilized parallel mLSTM, x (B, S, d) -> (B, S, d) [, the decode
  state after the last position]."""
  b, s, _ = x.shape
  h, dh = cfg.num_heads, cfg.head_dim
  q = einsum("bsd,dhk->bshk", x, p["w_q"]) / math.sqrt(dh)
  k = einsum("bsd,dhk->bshk", x, p["w_k"])
  v = einsum("bsd,dhk->bshk", x, p["w_v"])
  q = shard_activation(q, "heads")
  i_t, log_f = _mlstm_gates(p, x)
  # (B, S, H): on a DTensor, on blocks with the sequence whole
  f_cum = (_local.on_rows(torch.cumsum, log_f, 1, row_dims=(0, 2))
           if isinstance(log_f, DTensor) else torch.cumsum(log_f, dim=1))
  qc, kc = _chunk(cfg.q_chunk, s), _chunk(cfg.kv_chunk, s)
  fk_all = f_cum.transpose(1, 2)                          # (B, H, S)
  ik_all = i_t.transpose(1, 2)
  vf = v.to(torch.float32)
  outs = []
  for lo in range(0, s, qc):
    q_blk = q[:, lo:lo + qc]
    fq = fk_all[:, :, lo:lo + qc, None]                   # (B, H, cq, 1)
    q_pos = torch.arange(lo, lo + qc, device=x.device)[:, None]
    m = torch.full((b, h, qc), _NEG, dtype=torch.float32, device=x.device)
    num = torch.zeros((b, h, qc, dh), dtype=torch.float32, device=x.device)
    den = torch.zeros((b, h, qc), dtype=torch.float32, device=x.device)
    # Blocks above the diagonal add 0; the chunks divide s, so every block
    # has one shape.
    blocks, counting = _scan_steps(len(range(0, lo + qc, kc)))
    with counting:
      for klo in (kc * i for i in blocks):
        # mLSTM is linear in the q.k score; only gate decays are in the
        # exponent: w_{t,j} = exp(F_t - F_j + itilde_j - m_t) (q_t . k_j).
        score = einsum("bqhd,bkhd->bhqk", q_blk,
                       k[:, klo:klo + kc]).to(torch.float32)
        decay = (fq - fk_all[:, :, None, klo:klo + kc]
                 + ik_all[:, :, None, klo:klo + kc])
        kv_pos = torch.arange(klo, klo + kc, device=x.device)[None]
        decay = torch.where(kv_pos <= q_pos, decay,
                            torch.full((), _NEG, device=x.device))
        m_new = torch.maximum(m, torch.amax(decay, dim=-1))
        alpha = torch.exp(m - m_new)
        w = torch.exp(decay - m_new[..., None]) * score
        num = num * alpha[..., None] + einsum(
            "bhqk,bkhd->bhqd", w, vf[:, klo:klo + kc])
        den = den * alpha + torch.sum(w, dim=-1)
        m = m_new
    norm = torch.maximum(torch.abs(den), torch.exp(-m))
    outs.append((num / norm[..., None]).transpose(1, 2))  # (B, cq, H, dh)
  o = torch.cat(outs, dim=1)
  og = torch.sigmoid(einsum("bsd,dhk->bshk", x, p["w_o"]))
  y = einsum("bshk,hkd->bsd", og * o.to(og.dtype), p["w_out"])
  if not return_state:
    return y
  return y, _mlstm_state_from_seq(k, v, i_t, f_cum)


def _mlstm_state_from_seq(k, v, i_t, f_cum) -> Params:
  """Fold a whole sequence into (C, n, m) in one pass (for prefill)."""
  logw = (f_cum[:, -1][:, :, None] - f_cum.transpose(1, 2)
          + i_t.transpose(1, 2))                          # (B, H, S)
  m = torch.amax(logw, dim=-1)                            # (B, H)
  w = torch.exp(logw - m[..., None])
  kf, vf = k.to(torch.float32), v.to(torch.float32)
  c = einsum("bhs,bshk,bshv->bhkv", w, kf, vf)
  n = einsum("bhs,bshk->bhk", w, kf)
  return {"c": c, "n": n, "m": m}


def mlstm_init_state(cfg, batch: int, device=None) -> Params:
  """The empty state: C and n zeros, m = _NEG, f32."""
  h, dh = cfg.num_heads, cfg.head_dim
  f32 = torch.float32
  return {"c": torch.zeros((batch, h, dh, dh), dtype=f32, device=device),
          "n": torch.zeros((batch, h, dh), dtype=f32, device=device),
          "m": torch.full((batch, h), _NEG, dtype=f32, device=device)}


def mlstm_apply_decode(p: Params, x: torch.Tensor, state: Params, cfg):
  """One token, x (B, d).  Returns (y (B, d), state), the state written in
  place: q, k and v projected in the model dtype and taken to f32, the
  update and the read-out in f32, the output gate in the model dtype."""
  dh = cfg.head_dim
  f32 = torch.float32
  q = einsum("bd,dhk->bhk", x, p["w_q"]).to(f32) / math.sqrt(dh)
  k = einsum("bd,dhk->bhk", x, p["w_k"]).to(f32)
  v = einsum("bd,dhk->bhk", x, p["w_v"]).to(f32)
  i_t, log_f = _mlstm_gates(p, x)
  m_f = state["m"] + log_f
  m_new = torch.maximum(m_f, i_t)
  a = torch.exp(m_f - m_new)
  bgt = torch.exp(i_t - m_new)
  c = state["c"] * a[..., None, None] + bgt[..., None, None] * (
      k[..., :, None] * v[..., None, :])
  n = state["n"] * a[..., None] + bgt[..., None] * k
  c = shard_activation(c, "mlstm_state")
  num = einsum("bhk,bhkv->bhv", q, c)
  den = torch.abs(einsum("bhk,bhk->bh", q, n))
  out = num / torch.maximum(den, torch.exp(-m_new))[..., None]
  og = torch.sigmoid(einsum("bd,dhk->bhk", x, p["w_o"]))
  y = einsum("bhk,hkd->bd", og * out.to(og.dtype), p["w_out"])
  assign(state["c"], c)
  assign(state["n"], n)
  assign(state["m"], m_new)
  return y, state


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def slstm_init(cfg, gen: torch.Generator, dtype, device) -> Params:
  """The block's weights, drawn in the reference's order (w, r, w_out):
  the input weights ``w`` (d, 4, h, dh) N(0, 1) / sqrt(d), the recurrent
  weights ``r`` (h, dh, 4, dh), block-diagonal per head, N(0, 1) /
  sqrt(dh), both in ``dtype`` (the recurrence streams ``r`` every step);
  the gate biases ``b`` (4, h, dh) zeros in f32; ``w_out`` (h, dh, d)
  N(0, 1) / sqrt(d).  The gates are (i, f, z, o)."""
  d, h = cfg.d_model, cfg.num_heads
  dh = d // h
  return {"w": _normal(gen, (d, 4, h, dh), 1.0 / math.sqrt(d), dtype,
                       device),
          "r": _normal(gen, (h, dh, 4, dh), 1.0 / math.sqrt(dh), dtype,
                       device),
          "b": torch.zeros((4, h, dh), dtype=torch.float32, device=device),
          "w_out": _normal(gen, (h, dh, d), 1.0 / math.sqrt(d), dtype,
                           device)}


def slstm_init_state(cfg, batch: int, device=None) -> Params:
  """The empty state (B, H, dh) each, f32: c and h zeros, n = 1e-6,
  m = -10."""
  h, dh = cfg.num_heads, cfg.d_model // cfg.num_heads
  z = torch.zeros((batch, h, dh), dtype=torch.float32, device=device)
  return {"c": z, "n": z + _EPS_N, "m": z - 10.0, "h": z.clone()}


def _rec_weight(r: torch.Tensor, dtype) -> torch.Tensor:
  """``r`` (H, dh, 4, dh) as the (H, dh, 4 dh) right operand of a batched
  product over heads, in the scan's dtype."""
  return r.reshape(r.shape[0], r.shape[1], -1).to(dtype)


def _scan_steps(s: int):
  """A loop's ``s`` steps, each running the same ops at the same shapes,
  and the context they run in: all of them, in none.  A caller that counts
  ops may put one step counted ``s`` times in its place
  (``analysis.cost.CostMode`` does)."""
  return range(s), contextlib.nullcontext()


def _slstm_forward(u: torch.Tensor, r: torch.Tensor):
  """The recurrence over time.  ``u`` (S, H, B, 4, dh): the input
  projections plus the gate biases, in the scan's dtype (f32, or f64 in
  tests); ``r`` (H, dh, 4, dh).  Returns (hs, (c, n, m, h) after the last
  step, the per-step (pre, a, c, n)), every state (S,) H, B, dh; h is cast
  to ``r``'s dtype before each recurrent product (accumulated in the scan's
  dtype), as in the reference."""
  s, hh, b, _, dh = u.shape
  dt = u.dtype
  r2 = _rec_weight(r, dt)
  cast = r.dtype != dt
  pres = torch.empty_like(u)
  hs, a_s, cs, ns = (torch.empty((s, hh, b, dh), dtype=dt, device=u.device)
                     for _ in range(4))
  c = torch.zeros((hh, b, dh), dtype=dt, device=u.device)
  n = c + _EPS_N
  m = c - 10.0
  h = c
  steps, counting = _scan_steps(s)
  with counting:
    for t in steps:
      hr = h.to(r.dtype).to(dt) if cast else h
      pre = pres[t]
      torch.baddbmm(u[t].view(hh, b, 4 * dh), hr, r2,
                    out=pre.view(hh, b, 4 * dh))
      i_p, f_p, z_p, o_p = pre.unbind(2)
      m_f = m + F.logsigmoid(f_p)
      m_new = torch.maximum(m_f, i_p)
      a = torch.exp(m_f - m_new, out=a_s[t])
      bgt = torch.exp(i_p - m_new)
      c = torch.addcmul(bgt * torch.tanh(z_p), c, a, out=cs[t])
      n = torch.addcmul(bgt, n, a, out=ns[t])
      h = torch.div(torch.sigmoid(o_p) * c, torch.clamp_min(n, _EPS_N),
                    out=hs[t])
      m = m_new
  return hs, (c, n, m, h), (pres, a_s, cs, ns)


class SLSTMScan(torch.autograd.Function):
  """The sLSTM recurrence with the reference's hand-written backward.

  forward(u (S, H, B, 4, dh), r (H, dh, 4, dh)) -> (hs (S, H, B, dh), c, n,
  m, h (H, B, dh) after the last step).  backward: the reverse recurrence
  of ``_slstm_scan_bwd``; the gradient of ``u`` is each step's gate
  cotangent dpre (so the biases' and the input projections' follow from
  autograd outside), and of ``r`` one einsum over the sequence, cast to
  ``r``'s dtype.  m's cotangent is ignored: h is invariant to it."""

  @staticmethod
  def forward(ctx, u, r):
    hs, (c, n, m, h), (pres, a_s, cs, ns) = _slstm_forward(u, r)
    ctx.save_for_backward(r, hs, pres, a_s, cs, ns)
    return hs, c, n, m, h

  @staticmethod
  def backward(ctx, d_hs, d_c, d_n, _d_m, d_h):
    r, hs, pres, a_s, cs, ns = ctx.saved_tensors
    with span("repro_slstm_scan_bwd"):
      return _slstm_backward(r, hs, pres, a_s, cs, ns, d_hs, d_c, d_n, d_h)


def _shift_prev(post: torch.Tensor, init: float) -> torch.Tensor:
  """The states before each step: ``init``, then ``post`` but the last."""
  return torch.cat([torch.full_like(post[:1], init), post[:-1]], dim=0)


def _slstm_backward(r, hs, pres, a_s, cs, ns, d_hs, d_c, d_n, d_h):
  s, hh, b, _, dh = pres.shape
  dt = pres.dtype
  rt = _rec_weight(r, dt).transpose(1, 2)               # (H, 4 dh, dh)
  c_prev, n_prev = _shift_prev(cs, 0.0), _shift_prev(ns, _EPS_N)
  h_prev = _shift_prev(hs, 0.0)
  i_p, f_p, z_p, o_p = pres.unbind(3)
  # The factors that need no carry, for every step at once.
  sig_o, tanh_z = torch.sigmoid(o_p), torch.tanh(z_p)
  bgt = ns - a_s * n_prev                     # exact recurrence identity
  n_cl = torch.clamp_min(ns, _EPS_N)
  k_o = (cs / n_cl) * sig_o * (1.0 - sig_o)   # d o_pre / d h
  k_c = sig_o / n_cl                          # d c / d h
  k_n = torch.where(ns > _EPS_N, -sig_o * cs / (n_cl * n_cl),
                    torch.zeros((), dtype=dt, device=ns.device))
  k_z = bgt * (1.0 - tanh_z * tanh_z)         # d z_pre / d c
  k_f = a_s * torch.sigmoid(-f_p)             # d/dx log_sigmoid = sig(-x)
  del i_p, f_p, z_p, o_p, sig_o, n_cl
  dpres = torch.empty_like(pres)
  dc, dn, dh_rec = d_c, d_n, d_h
  steps, counting = _scan_steps(s)
  with counting:
    for t in reversed(steps):
      dh_total = d_hs[t] + dh_rec
      dpre = dpres[t]                            # (H, B, 4, dh)
      torch.mul(dh_total, k_o[t], out=dpre[:, :, 3])
      dc_t = torch.addcmul(dc, dh_total, k_c[t])
      dn_t = torch.addcmul(dn, dh_total, k_n[t])
      d_a = torch.addcmul(dc_t * c_prev[t], dn_t, n_prev[t])
      torch.mul(d_a, k_f[t], out=dpre[:, :, 1])
      torch.mul(dc_t, k_z[t], out=dpre[:, :, 2])
      torch.mul(bgt[t], torch.addcmul(dn_t, dc_t, tanh_z[t]),
                out=dpre[:, :, 0])
      dh_rec = torch.bmm(dpre.view(hh, b, 4 * dh), rt)
      dc, dn = dc_t * a_s[t], dn_t * a_s[t]
  # ONE weight-gradient contraction for the whole sequence.
  d_r = einsum("shbgv,shbk->hkgv", dpres, h_prev).to(r.dtype)
  return dpres, d_r


def _slstm_scan(u: torch.Tensor, r: torch.Tensor):
  """``SLSTMScan`` on u (S, H, B, 4, dh); on a DTensor u, on each rank's
  heads and batch rows (the sequence and the widths whole), with its heads'
  slice of r (H, dh, 4, dh) made whole, whose gradient is then partial.
  Returns (hs (S, H, B, dh), c, n, m, h (H, B, dh))."""
  if not isinstance(u, DTensor):
    return SLSTMScan.apply(u, r)
  mesh = u.device_mesh
  want = _local.keep_placements(u, (1, 2))
  u = _local.to_placements(u, want)
  r = _local.to_placements(r, (Replicate(),) * mesh.ndim)
  lo, hi = _local.shard_range(u, 1)
  grad_r = tuple(Partial() if isinstance(p, Shard) else Replicate()
                 for p in want)
  outs = SLSTMScan.apply(u.to_local(),
                         r.to_local(grad_placements=grad_r)[lo:hi])
  s, h, b, _, dh = u.shape
  state_pl = tuple(Shard(p.dim - 1) if isinstance(p, Shard) else p
                   for p in want)
  wrapped = [DTensor.from_local(outs[0], mesh, want,
                                shape=torch.Size((s, h, b, dh)),
                                stride=(h * b * dh, b * dh, dh, 1))]
  wrapped += [DTensor.from_local(t, mesh, state_pl,
                                 shape=torch.Size((h, b, dh)),
                                 stride=(b * dh, dh, 1)) for t in outs[1:]]
  return tuple(wrapped)


def slstm_apply_seq(p: Params, x: torch.Tensor, cfg, *,
                    return_state: bool = False):
  """The sLSTM over a sequence, x (B, S, d) -> (B, S, d) [, the decode
  state after the last position, (B, H, dh) f32 each].  The input
  projections are taken in f32 from x cast to the weights' dtype (the
  reference's ``preferred_element_type``); the hidden states are cast to
  x's dtype before ``w_out``."""
  w = p["w"]
  f32 = torch.float32
  xw = einsum("bsd,dghk->shbgk", x.to(w.dtype).to(f32), w.to(f32))
  u = (xw + p["b"].transpose(0, 1)[:, None]).contiguous()  # (S, H, B, 4, dh)
  with span("repro_slstm_scan"):
    hs, c, n, m, h = _slstm_scan(u, p["r"])
  y = einsum("shbk,hkd->bsd", hs.to(x.dtype), p["w_out"])
  if not return_state:
    return y
  return y, {name: t.transpose(0, 1) for name, t in
             (("c", c), ("n", n), ("m", m), ("h", h))}


def slstm_apply_decode(p: Params, x: torch.Tensor, state: Params, cfg):
  """One token, x (B, d): one step of the cell (the reference's
  ``_slstm_cell``) on the state, written in place.  Returns (y (B, d),
  state)."""
  w, r = p["w"], p["r"]
  f32 = torch.float32
  xw = einsum("bd,dghk->bghk", x.to(w.dtype).to(f32), w.to(f32))
  rec = einsum("bhk,hkgv->bghv", state["h"].to(r.dtype).to(f32),
                     r.to(f32))
  pre = xw + rec + p["b"]
  i_p, f_p, z_p, o_p = pre.unbind(1)
  m_f = state["m"] + _local.elementwise(F.logsigmoid, f_p)
  m_new = torch.maximum(m_f, i_p)
  a = torch.exp(m_f - m_new)
  bgt = torch.exp(i_p - m_new)
  c = state["c"] * a + bgt * torch.tanh(z_p)
  n = state["n"] * a + bgt
  hid = torch.sigmoid(o_p) * c / torch.clamp_min(n, _EPS_N)
  for name, t in (("c", c), ("n", n), ("m", m_new), ("h", hid)):
    assign(state[name], t)
  y = einsum("bhk,hkd->bd", hid.to(x.dtype), p["w_out"])
  return y, state
