"""The plain reference of the two configurations' models, in float32.

Written from the configuration file's dimensions, not from the program:
RMSNorm (f32, eps from the file), RoPE on the two halves of the rotated
dims, causal softmax attention (GQA: query head h reads kv head h // G;
or MLA in its expanded form, with the shared RoPE key), the MoE FFN with
the paper's soft top-k router (``softsort.soft_topk_mask``, eps from the
file) and hard top-k dispatch with capacity in groups of tokens, SwiGLU
experts and shared experts, the untied head with an optional tanh
soft-cap, and the per-token NLL.  The semantics that decide which token
reaches which expert are the configuration's own and are stated in its
file: ``group_size`` tokens a group (the tail padded with zero rows, which
are routed too), capacity max(ceil(group * k * capacity_factor / E), 4)
slots an expert, k rounds each sending every token to its largest
remaining weight (the first expert among equals) while the expert has
room, the weights being the mask times the softmax, renormalised.

``Precision`` carries the arithmetic: float32 with TF32 off, or the
control's float8 (``Precision``).  Imports nothing of the program.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from chipbench.reference.softsort import soft_topk_mask

_F8_MAX = 448.0


class Precision:
  """The arithmetic: plain float32, or with ``fp8`` the configuration's
  bfloat16 one step down, float8 e4m3 (one scale a tensor, amax / 448, the
  gradient passed straight through) wherever the program holds a tensor in
  the configuration's dtype: both operands and the output of every product
  but the attention scores (which the program keeps in f32), the residual
  stream after each block's additions, the embedded tokens, and for
  training the parameters after each update."""

  def __init__(self, fp8: bool = False):
    self.fp8 = fp8

  def q(self, x: torch.Tensor) -> torch.Tensor:
    if not self.fp8:
      return x
    scale = x.detach().abs().amax().clamp(min=1e-30) / _F8_MAX
    xq = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (xq - x).detach() if x.requires_grad else xq

  def einsum(self, eq: str, a: torch.Tensor, b: torch.Tensor,
             stored: bool = True):
    out = torch.einsum(eq, self.q(a), self.q(b))
    return self.q(out) if stored else out


F32 = Precision(False)
FP8 = Precision(True)


def no_tf32() -> None:
  """float32 products in float32 (the card would use TF32 otherwise)."""
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  torch.set_float32_matmul_precision("highest")


def rmsnorm(x, scale, eps):
  return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
  """x (..., S, H, D) at positions (S,): the two halves of D rotated."""
  half = x.shape[-1] // 2
  freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                 device=x.device) / half)
  ang = positions.to(torch.float32)[:, None] * freq            # (S, half)
  cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
  x1, x2 = x[..., :half], x[..., half:]
  return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, q_pos, k_pos, prec: Precision, chunk: int = 512):
  """Causal softmax attention, scale 1/sqrt(D): q (B, S, H, D) at q_pos,
  k (B, T, Hkv, D) and v (B, T, Hkv, Dv) at k_pos; query head h reads kv
  head h // (H / Hkv).  Queries in chunks, to bound the scores' memory."""
  b, s, h, d = q.shape
  hkv = k.shape[2]
  g = h // hkv
  scale = 1.0 / math.sqrt(d)
  out = []
  for lo in range(0, s, chunk):
    qc = q[:, lo:lo + chunk].reshape(b, -1, hkv, g, d)
    sc = prec.einsum("bqhgd,bkhd->bhgqk", qc, k, stored=False) * scale
    mask = k_pos[None, :] <= q_pos[lo:lo + chunk, None]
    sc = torch.where(mask, sc, torch.full((), float("-inf"), device=q.device))
    p = torch.softmax(sc, dim=-1)
    o = prec.einsum("bhgqk,bkhd->bqhgd", p, v)
    out.append(o.reshape(b, -1, h, v.shape[-1]))
  return torch.cat(out, dim=1)


def mla_seq(p, x, positions, m, prec: Precision):
  """DeepSeek-V2's latent attention, expanded, over a whole sequence:
  x (B, S, d) -> (B, S, d)."""
  nd, rd, r = m["qk_nope_dim"], m["qk_rope_dim"], m["kv_lora_rank"]
  q = prec.einsum("bsd,dhk->bshk", x, p["wq"])
  q = torch.cat([q[..., :nd], rope(q[..., nd:], positions, m["rope_theta"])],
                dim=-1)
  ckv = prec.einsum("bsd,dr->bsr", x, p["w_dkv"])
  c_kv = ckv[..., :r]
  k_rope = rope(ckv[..., None, r:], positions, m["rope_theta"])
  k_nope = prec.einsum("bsr,rhk->bshk", c_kv, p["w_uk"])
  v = prec.einsum("bsr,rhk->bshk", c_kv, p["w_uv"])
  k = torch.cat([k_nope, k_rope.expand(-1, -1, m["heads"], -1)], dim=-1)
  o = attention(q, k, v, positions, positions, prec)
  return prec.einsum("bshk,hkd->bsd", o, p["wo"])


def gqa_qkv(p, x, positions, m, prec: Precision):
  """q (B, S, H, dh), k and v (B, S, Hkv, dh), RoPE applied to q and k."""
  q = prec.einsum("bsd,dhk->bshk", x, p["wq"])
  k = prec.einsum("bsd,dhk->bshk", x, p["wk"])
  v = prec.einsum("bsd,dhk->bshk", x, p["wv"])
  return (rope(q, positions, m["rope_theta"]),
          rope(k, positions, m["rope_theta"]), v)


def capacity(group: int, m: dict) -> int:
  k, e = m["experts_per_token"], m["experts"]
  return max(int(math.ceil(group * k * m["capacity_factor"] / e)), 4)


def route(weights: torch.Tensor, k: int, cap: int):
  """Hard top-k dispatch with capacity.  weights (G, T, E) -> (the token
  of each slot (G, E * cap), T where empty; the gate of each slot (G, E *
  cap), differentiable; the dispatch indicator (G, T, E))."""
  g, t, e = weights.shape
  dev = weights.device
  w = weights
  fill = torch.zeros((g, e), dtype=torch.int64, device=dev)
  sent = torch.zeros((g, t, e), dtype=weights.dtype, device=dev)
  slot_tok = torch.full((g, e * cap), t, dtype=torch.int64, device=dev)
  flat_idx, gates = [], []
  rows = torch.arange(g, device=dev)[:, None].expand(g, t)
  toks = torch.arange(t, device=dev)[None, :].expand(g, t)
  for _ in range(k):
    idx = torch.argmax(w.detach(), dim=-1)                       # (G, T)
    onehot = F.one_hot(idx, e).to(torch.int64)
    before = torch.cumsum(onehot, dim=1) - onehot                # (G, T, E)
    pos = (torch.gather(fill, 1, idx)
           + torch.gather(before, 2, idx[..., None])[..., 0])    # (G, T)
    ok = pos < cap
    gate = torch.gather(w, -1, idx[..., None])[..., 0]
    slot = idx * cap + pos
    sel = ok.nonzero(as_tuple=True)
    slot_tok[sel[0], slot[sel]] = toks[sel]
    flat_idx.append(rows[sel] * (e * cap) + slot[sel])
    gates.append(gate[sel])
    sent = sent + onehot.to(weights.dtype) * ok[..., None].to(weights.dtype)
    fill = fill + torch.sum(onehot, dim=1)
    w = w * (1.0 - onehot.to(w.dtype))
  slot_gate = torch.zeros(g * e * cap, dtype=weights.dtype, device=dev)
  slot_gate = slot_gate.index_put((torch.cat(flat_idx),), torch.cat(gates))
  return slot_tok, slot_gate.reshape(g, e * cap), sent


def moe(p, x, m, prec: Precision):
  """The MoE FFN of tokens x (T, d): (out (T, d), the load-balance loss
  E * <share dispatched, mean probability>)."""
  t_total, d = x.shape
  gs = min(m["group_size"], t_total)
  pad = (-t_total) % gs
  xt = torch.cat([x, x.new_zeros((pad, d))]) if pad else x
  xg = xt.reshape(-1, gs, d)
  g = xg.shape[0]
  logits = prec.einsum("gtd,de->gte", xg, p["router"], stored=False)
  probs = torch.softmax(logits, dim=-1)
  k, e = m["experts_per_token"], m["experts"]
  mask = soft_topk_mask(logits, k, m["router_eps"])
  w = mask * probs
  w = w / torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-9)
  cap = capacity(gs, m)
  slot_tok, slot_gate, sent = route(w, k, cap)
  xpad = torch.cat([xg, xg.new_zeros((g, 1, d))], dim=1)
  xe = torch.gather(xpad, 1, slot_tok[..., None].expand(-1, -1, d))
  xe = xe.reshape(g, e, cap, d)
  h = (F.silu(prec.einsum("gecd,edf->gecf", xe, p["we_gate"]))
       * prec.einsum("gecd,edf->gecf", xe, p["we_in"]))
  ye = prec.einsum("gecf,efd->gecd", h, p["we_out"]).reshape(g, e * cap, d)
  out = torch.zeros((g, gs + 1, d), dtype=x.dtype, device=x.device)
  out = out.scatter_add(1, slot_tok[..., None].expand(-1, -1, d),
                        ye * slot_gate[..., None])
  y = out[:, :gs].reshape(-1, d)[:t_total]
  if "shared" in p:
    s = p["shared"]
    hs = (F.silu(prec.einsum("td,df->tf", x, s["w_gate"]))
          * prec.einsum("td,df->tf", x, s["w_in"]))
    y = y + prec.einsum("tf,fd->td", hs, s["w_out"])
  frac = torch.mean(sent, dim=(0, 1))
  aux = e * torch.sum(frac * torch.mean(probs, dim=(0, 1)))
  return y, aux


def layer_seq(p, x, positions, m, prec: Precision, keep_kv: bool = False):
  """One block over whole sequences x (B, S, d): (x, aux, (k, v) of a GQA
  layer after RoPE where ``keep_kv``, else None)."""
  eps = m["norm_eps"]
  h = rmsnorm(x, p["norm1"]["scale"], eps)
  kv = None
  if m["kind"] == "mla_moe":
    x = prec.q(x + mla_seq(p["mla"], h, positions, m, prec))
  else:
    a = p["attn"]
    q, k, v = gqa_qkv(a, h, positions, m, prec)
    o = attention(q, k, v, positions, positions, prec)
    x = prec.q(x + prec.einsum("bshk,hkd->bsd", o, a["wo"]))
    kv = (k, v) if keep_kv else None
  b, s, d = x.shape
  y, aux = moe(p["ffn"], rmsnorm(x, p["norm2"]["scale"], eps).reshape(-1, d),
               m, prec)
  return prec.q(x + y.reshape(b, s, d)), aux, kv


def head_logits(top, x, m, prec: Precision):
  """f32 logits of hidden states x (..., d): the final norm, the head and
  the soft-cap c tanh(l / c) where the file has one."""
  x = rmsnorm(x, top["final_norm"]["scale"], m["norm_eps"])
  logits = prec.einsum("...d,dv->...v", x, top["lm_head"]["w"])
  cap = m["logit_softcap"]
  return torch.tanh(logits / cap) * cap if cap > 0 else logits


def token_nll(top, x, targets, m, prec: Precision):
  """Per-token NLL (B, S) of hidden states x (B, S, d)."""
  logits = head_logits(top, x, m, prec)
  return (torch.logsumexp(logits, dim=-1)
          - torch.gather(logits, -1, targets[..., None])[..., 0])
