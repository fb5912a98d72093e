"""Layer primitives of the language models (port of
``repro.models.layers``): norms, RoPE, grouped-query self- and
cross-attention, the dense FFN and the token-choice mixture of experts
(``moe_apply``).  The expert-parallel dispatch (``moe_apply_ep``) waits
with the rest of the multi-card work (``ROADMAP.md``, Queue 1 item 6).

Conventions, as in the reference:

* weights are stored "math-shaped": wq (D, H, hd), wk/wv (D, KH, hd),
  wo (H, hd, D), FFN w_in/w_gate (D, F), w_out (F, D);
* activations are (B, S, D) in the model's dtype; norms reduce in
  float32 and cast back;
* attention is query-chunked with a mask built on the fly, so the
  (B, H, S, S) scores never exist whole past ``q_chunk`` queries;
  decode is the same function with one query against a KV cache.

**Score precision.**  The reference asks XLA for float32 results of its
bf16 score and probability-times-value products
(``preferred_element_type=float32``).  A bf16 ``torch.matmul`` would
round both results to bf16, so ``attention`` upcasts its operands to
float32 and multiplies in float32: bf16 x bf16 products are exact in
float32, so this is the reference's arithmetic (float32 sums of exact
products) up to the order of the sums.  It reads a float32 copy of K
and V, a cost the reference's comment names; at decode it is the
cache's size, small beside the weights each step reads (``PERF.md``).
With TF32 off (PyTorch's default for matmuls) the float32 products are
full float32 on the card too.  The model's other products (projections,
FFN, unembedding) stay bf16 matmuls with float32 accumulation.

**MoE without float atomics.**  The reference packs each expert's tokens
into an (E, C, D) buffer by a scatter and combines by a scatter-add
(``y.at[st].add(vals)``).  On the card an ``index_add_`` would add a
token's k contributions with float atomics, in arrival order, rounding
each bf16 add differently from run to run.  ``moe_apply`` gathers
instead: each buffer slot reads the token at its expert's capacity
rank, and each token reads back its k rows and adds them one by one in
the reference's order (ascending expert id, from zero, in the model's
dtype).  Two runs on the same tokens give the same bits.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import DeviceLike, resolve_device


# ---------------------------------------------------------------------------
# norms / rope
# ---------------------------------------------------------------------------

def from_numpy(a, device) -> torch.Tensor:
    """A numpy (or ``ml_dtypes`` bfloat16) array as a tensor of its own
    dtype on ``device``: a writable copy; bfloat16 goes exactly through
    float32."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def tree_from_numpy(node, device):
    """``from_numpy`` on every leaf of a tree of dicts and lists (a tuple
    becomes a list)."""
    if isinstance(node, dict):
        return {k: tree_from_numpy(v, device) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [tree_from_numpy(v, device) for v in node]
    return from_numpy(node, device)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    nrm = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (nrm * (1.0 + scale.float())).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (S,) or (B, S)."""
    hd = x.shape[-1]
    half = hd // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    pos = positions.to(torch.float32)
    if positions.dim() == 1:
        ang = pos[None, :, None] * freq[None, None, :]
    else:
        ang = pos[..., None] * freq
    ang = ang[:, :, None, :]                           # (B|1, S, 1, half)
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _mask_bias(q_pos: torch.Tensor, kv_pos: torch.Tensor, causal: bool,
               window: Optional[int]) -> torch.Tensor:
    """(Sq, Skv) additive float32 bias: 0 allowed, -inf masked.

    Negative kv positions are always masked: ring-buffer KV caches mark
    slots not yet written with them."""
    ok = kv_pos[None, :] >= 0
    if causal:
        ok = ok & (kv_pos[None, :] <= q_pos[:, None])
    if window is not None:
        ok = ok & (kv_pos[None, :] > (q_pos[:, None] - window))
    zero = torch.zeros((), dtype=torch.float32, device=ok.device)
    return torch.where(ok, zero, float("-inf"))


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              q_positions: torch.Tensor, kv_positions: torch.Tensor,
              causal: bool = True, window: Optional[int] = None,
              q_chunk: int = 512, scale: Optional[float] = None
              ) -> torch.Tensor:
    """Grouped-query attention, query-chunked.

    q: (B, Sq, H, hd); k, v: (B, Skv, KH, hd); H % KH == 0.
    Returns (B, Sq, H, hd) in q's dtype.  Scores and the weighted sum
    of values are float32 products of the stored operands (module
    docstring)."""
    B, Sq, H, hd = q.shape
    Skv, KH = k.shape[1], k.shape[2]
    G = H // KH
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    kt = k.float().permute(0, 2, 3, 1)                # (B, KH, hd, Skv)
    vt = v.float().permute(0, 2, 1, 3)                # (B, KH, Skv, hd)

    def block(q_blk: torch.Tensor, qpos_blk: torch.Tensor) -> torch.Tensor:
        C = q_blk.shape[1]
        # (B, C, KH, G, hd) -> (B, KH, G*C, hd): one product per kv head
        qh = q_blk.float().reshape(B, C, KH, G, hd).permute(0, 2, 3, 1, 4)
        s = torch.matmul(qh.reshape(B, KH, G * C, hd), kt) * scale
        s = s.reshape(B, KH, G, C, Skv)
        s = s + _mask_bias(qpos_blk, kv_positions, causal, window)
        p = torch.softmax(s, dim=-1)
        p = p.to(v.dtype).float().reshape(B, KH, G * C, Skv)
        o = torch.matmul(p, vt).reshape(B, KH, G, C, hd)
        return o.permute(0, 3, 1, 2, 4).reshape(B, C, H, hd).to(q.dtype)

    if Sq <= q_chunk:
        return block(q, q_positions)
    pad = (-Sq) % q_chunk
    if pad:
        q = F.pad(q, (0, 0, 0, 0, 0, pad))
        q_positions = F.pad(q_positions, (0, pad))
    outs = [block(q[:, i:i + q_chunk], q_positions[i:i + q_chunk])
            for i in range(0, q.shape[1], q_chunk)]
    return torch.cat(outs, dim=1)[:, :Sq]


@dataclasses.dataclass(frozen=True)
class AttnSpec:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    causal: bool = True
    window: Optional[int] = None
    use_rope: bool = True


def _normal(g: torch.Generator, shape, scale: float, dtype,
            device) -> torch.Tensor:
    """N(0, scale^2) drawn in float32 from ``g``, cast to ``dtype``; scaled
    in place, so the float32 draw is the only temporary (kimi-k2's
    expert stack is 22.5 GB of it)."""
    return torch.randn(shape, generator=g, device=device,
                       dtype=torch.float32).mul_(scale).to(dtype)


def attn_init(generator: torch.Generator, s: AttnSpec,
              dtype=torch.bfloat16, device: DeviceLike = None) -> dict:
    """The reference's shapes, scales and dtypes, drawn from
    ``generator`` (on ``device``, the card unless named)."""
    device = resolve_device(device)
    D, H, KH, hd = s.d_model, s.n_heads, s.n_kv_heads, s.head_dim
    sd = 1.0 / math.sqrt(D)
    p = {
        "wq": _normal(generator, (D, H, hd), sd, dtype, device),
        "wk": _normal(generator, (D, KH, hd), sd, dtype, device),
        "wv": _normal(generator, (D, KH, hd), sd, dtype, device),
        "wo": _normal(generator, (H, hd, D), 1.0 / math.sqrt(H * hd), dtype,
                      device),
    }
    if s.qkv_bias:
        p["bq"] = torch.zeros((H, hd), dtype=dtype, device=device)
        p["bk"] = torch.zeros((KH, hd), dtype=dtype, device=device)
        p["bv"] = torch.zeros((KH, hd), dtype=dtype, device=device)
    return p


def proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matmul."""
    D, H, hd = w.shape
    return torch.matmul(x, w.reshape(D, H * hd)).reshape(
        x.shape[:-1] + (H, hd))


def attn_out(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd") as one matmul."""
    H, hd, D = wo.shape
    return torch.matmul(o.reshape(o.shape[:-2] + (H * hd,)),
                        wo.reshape(H * hd, D))


def attn_qkv(p: dict, s: AttnSpec, x: torch.Tensor,
             positions: torch.Tensor, kv_x: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Projected q, k, v (B, S, {H|KH}, hd), with the biases and RoPE;
    K and V from ``kv_x`` (cross-attention, no RoPE) when it is given."""
    src = x if kv_x is None else kv_x
    q, k, v = proj(x, p["wq"]), proj(src, p["wk"]), proj(src, p["wv"])
    if s.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if s.use_rope and kv_x is None:
        q = rope(q, positions, s.rope_theta)
        k = rope(k, positions, s.rope_theta)
    return q, k, v


def kv_quantize(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., hd) -> (int8 codes, per-(...) float16 scales)."""
    tf = t.float()
    m = torch.amax(torch.abs(tf), dim=-1)
    scale = torch.clamp(m, min=1e-8) / 127.0
    q = torch.clamp(torch.round(tf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale.to(torch.float16)


def kv_dequantize(q: torch.Tensor, scale: torch.Tensor,
                  dtype) -> torch.Tensor:
    return (q.float() * scale.float()[..., None]).to(dtype)


def attn_cache_init(s: AttnSpec, batch: int, max_len: int,
                    dtype=torch.bfloat16, device: DeviceLike = None,
                    int8: bool = False) -> dict:
    """Zero K/V cache on ``device`` (the card unless named): K and V in
    ``dtype``, or (``int8``) as int8 codes with a float16 scale a token
    and head.  Without a window it holds ``max_len`` slots, slot i for
    position i; with one it is a ring of min(window, max_len) slots,
    slot i for the newest position p with p % slots == i."""
    device = resolve_device(device)
    slots = min(s.window, max_len) if s.window is not None else max_len
    shape = (batch, slots, s.n_kv_heads, s.head_dim)
    if not int8:
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_s": torch.zeros(shape[:-1], dtype=torch.float16,
                               device=device),
            "v_s": torch.zeros(shape[:-1], dtype=torch.float16,
                               device=device)}


def slot_index(value, device) -> torch.Tensor:
    """A one-element long index from a Python int (a fill, no host to
    device copy) or a 0-d tensor: a decode step's position."""
    if isinstance(value, torch.Tensor):
        return value.reshape(1).to(device=device, dtype=torch.long)
    return torch.full((1,), int(value), dtype=torch.long, device=device)


def ring_positions(pos: torch.Tensor, slots: int) -> torch.Tensor:
    """Positions held by ring slots 0..slots-1 at time ``pos`` (1,):
    slot i holds the newest p <= pos with p % slots == i (negative =
    not yet written; ``_mask_bias`` masks them)."""
    i = torch.arange(slots, device=pos.device)
    return pos - torch.remainder(pos - i, slots)


def _cache_store(s: AttnSpec, cache: dict, k: torch.Tensor,
                 v: torch.Tensor, positions: torch.Tensor) -> None:
    """Writes the K/V of ``positions`` into ``cache`` in place: a
    prefill's (positions from 0; the first slots, or for a ring the
    last ``slots`` positions) or one decode token's."""
    if cache["k"].dtype == torch.int8:
        (kq, ks), (vq, vs) = kv_quantize(k), kv_quantize(v)
        values = {"k": kq, "v": vq, "k_s": ks, "v_s": vs}
    else:
        values = {"k": k.to(cache["k"].dtype), "v": v.to(cache["v"].dtype)}
    slots, S = cache["k"].shape[1], k.shape[1]
    take = min(slots, S)
    if s.window is None and S > 1:
        for name, val in values.items():
            cache[name][:, :take] = val[:, :take]
        return
    idx = positions[-take:].long()
    if s.window is not None:
        idx = torch.remainder(idx, slots)
    for name, val in values.items():
        cache[name].index_copy_(1, idx, val[:, -take:])


def _cache_read(s: AttnSpec, cache: dict, positions: torch.Tensor,
                dtype) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(K, V, their positions) of the cache at decode position
    ``positions`` (1,)."""
    slots = cache["k"].shape[1]
    if s.window is not None:
        kv_pos = ring_positions(positions, slots)
    else:
        kv_pos = torch.arange(slots, device=positions.device)
    if cache["k"].dtype == torch.int8:
        return (kv_dequantize(cache["k"], cache["k_s"], dtype),
                kv_dequantize(cache["v"], cache["v_s"], dtype), kv_pos)
    return cache["k"], cache["v"], kv_pos


def attn_apply(p: dict, s: AttnSpec, x: torch.Tensor,
               positions: torch.Tensor, cache: Optional[dict] = None,
               kv_x: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, Optional[dict]]:
    """Self- or cross-attention: the mixer of the LM's ``attn`` and
    ``local`` blocks and the encoder-decoder's attention.  ``positions``
    (S,) are x's positions.

    * ``kv_x`` given: cross-attention, K and V from the encoder sequence
      ``kv_x`` (no RoPE, no causal mask, no cache);
    * ``cache`` None: full-sequence attention over x (train);
    * ``cache`` given, S > 1: the same, and x's K/V fill the cache
      (prefill);
    * ``cache`` given, S == 1: x's K/V go into the cache at its
      position and the query attends over the cache (decode).

    The cache (``attn_cache_init``) is written in place and returned:
    the reference returns a new one, but an eager copy of every layer's
    cache a token would double a decode step's cache traffic."""
    q, k, v = attn_qkv(p, s, x, positions, kv_x)
    if kv_x is not None:
        if cache is not None:
            raise ValueError("cross-attention takes no cache")
        kv_pos = torch.arange(kv_x.shape[1], device=kv_x.device)
        o = attention(q, k, v, positions, kv_pos, causal=False,
                      window=s.window)
    elif cache is not None and x.shape[1] == 1:
        _cache_store(s, cache, k, v, positions)
        k, v, kv_pos = _cache_read(s, cache, positions, q.dtype)
        o = attention(q, k, v, positions, kv_pos, causal=True,
                      window=s.window)
    else:
        o = attention(q, k, v, positions, positions, causal=s.causal,
                      window=s.window)
        if cache is not None:
            _cache_store(s, cache, k, v, positions)
    return attn_out(o, p["wo"]), cache


# ---------------------------------------------------------------------------
# FFN (dense)
# ---------------------------------------------------------------------------

def ffn_init(generator: torch.Generator, d_model: int, d_ff: int, kind: str,
             dtype=torch.bfloat16, sparse: bool = False,
             initial_fan_in: Optional[int] = None,
             device: DeviceLike = None) -> dict:
    """Dense FFN; ``sparse=True`` stores the up/gate projections in the
    paper's Alg.-1 theta/sign form: w = theta * sign * 1(theta > 0),
    float32 whatever the model's dtype (as the reference's
    ``init_theta_layer`` makes them), with the Alg.-2 controller
    (``lm.apply_sparse_control``) holding each hidden unit's fan-in."""
    from repro_torch.core.masking import init_theta_layer

    device = resolve_device(device)
    sd_in = 1.0 / math.sqrt(d_model)
    p = {"w_out": _normal(generator, (d_ff, d_model), 1.0 / math.sqrt(d_ff),
                          dtype, device)}

    def one(name):
        if not sparse:
            p[name] = _normal(generator, (d_model, d_ff), sd_in, dtype,
                              device)
            return
        tl = init_theta_layer(generator, d_model, d_ff, initial_fan_in,
                              device=device)
        p[name + "_theta"] = tl.theta * sd_in
        p[name + "_sign"] = tl.sign

    one("w_in")
    if kind == "swiglu":
        one("w_gate")
    return p


def _ffn_weight(p: dict, name: str, dtype) -> torch.Tensor:
    if name in p:
        return p[name]
    theta, sign = p[name + "_theta"], p[name + "_sign"]
    active = (theta > 0).to(theta.dtype)
    return (theta * sign * active).to(dtype)


def ffn_apply(p: dict, kind: str, x: torch.Tensor) -> torch.Tensor:
    h = torch.matmul(x, _ffn_weight(p, "w_in", x.dtype))
    if kind == "swiglu":
        g = torch.matmul(x, _ffn_weight(p, "w_gate", x.dtype))
        h = F.silu(g) * h
    elif kind == "gelu":
        h = F.gelu(h, approximate="tanh")     # jax.nn.gelu's default
    elif kind == "relu2":
        h = torch.square(F.relu(h))
    else:
        raise ValueError(kind)
    return torch.matmul(h, p["w_out"])


# ---------------------------------------------------------------------------
# Mixture of Experts (token-choice top-k, grouped GEMM dispatch)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MoESpec:
    n_experts: int
    top_k: int
    d_model: int
    d_ff: int
    capacity_factor: float = 1.25
    shared_expert: bool = False


def moe_init(generator: torch.Generator, s: MoESpec, dtype=torch.bfloat16,
             device: DeviceLike = None) -> dict:
    """The reference's shapes, scales and dtypes (a float32 router),
    drawn from ``generator`` on ``device`` (the card unless named)."""
    device = resolve_device(device)
    E, D, Fe = s.n_experts, s.d_model, s.d_ff
    sd_in, sd_out = 1.0 / math.sqrt(D), 1.0 / math.sqrt(Fe)
    p = {
        "router": {"w": _normal(generator, (D, E), sd_in, torch.float32,
                                device)},
        "experts": {
            "w_in": _normal(generator, (E, D, Fe), sd_in, dtype, device),
            "w_gate": _normal(generator, (E, D, Fe), sd_in, dtype, device),
            "w_out": _normal(generator, (E, Fe, D), sd_out, dtype, device),
        },
    }
    if s.shared_expert:
        p["shared"] = ffn_init(generator, D, Fe, "swiglu", dtype,
                               device=device)
    return p


def moe_capacity(s: MoESpec, n_tokens: int, no_drop: bool = False) -> int:
    """Slots per expert: every token (``no_drop``), else the reference's
    ``max(1, round(T k / E * capacity_factor))`` (Python's round)."""
    if no_drop:
        return n_tokens
    return int(max(1, round(n_tokens * s.top_k / s.n_experts
                            * s.capacity_factor)))


def _counts(idx: torch.Tensor, n: int) -> torch.Tensor:
    """How often each of 0..n-1 occurs in ``idx``, as an integer
    scatter-add: exact in any order, and (unlike ``torch.bincount`` on
    the card) no wait for the device to learn the output's size."""
    return torch.zeros(n, dtype=torch.long, device=idx.device).scatter_add_(
        0, idx, torch.ones_like(idx))


def moe_route(p: dict, s: MoESpec, xt: torch.Tensor):
    """Router of (T, D) tokens -> (gates (T, k), eids (T, k), aux).  The
    top k by a stable descending sort: ties go to the lower expert id,
    as ``jax.lax.top_k`` breaks them.  ``aux`` is the
    Switch-style load-balancing loss on each token's first choice."""
    E = s.n_experts
    logits = xt.float() @ p["router"]["w"]
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, eids = vals[:, :s.top_k], idx[:, :s.top_k]
    gates = gates / torch.sum(gates, dim=-1, keepdim=True)
    density = _counts(eids[:, 0], E).float() / xt.shape[0]
    aux = torch.sum(density * torch.mean(probs, dim=0)) * E
    return gates, eids, aux


def moe_dispatch(s: MoESpec, eids: torch.Tensor, cap: int):
    """Slot bookkeeping of the assignments (T, k) at ``cap`` slots an
    expert, as the reference sorts them (stably by expert, so each
    expert's tokens in token order).  Returns (slot_tok (E, cap) token
    of each slot, slot_ok (E, cap) whether it is filled, slot (T, k)
    flat slot e * cap + rank of each assignment, keep (T, k) whether it
    fits)."""
    T, k = eids.shape
    E, A = s.n_experts, T * k
    flat_e = eids.reshape(A)
    order = torch.argsort(flat_e, stable=True)
    counts = _counts(flat_e, E)
    starts = torch.cumsum(counts, 0) - counts
    # rank of assignment a among its expert's, in the sorted order
    inv = torch.empty_like(order).scatter_(
        0, order, torch.arange(A, device=eids.device))
    rank = (inv - starts[flat_e]).reshape(T, k)
    keep = rank < cap
    slot = torch.where(keep, eids * cap + rank, 0)
    c = torch.arange(cap, device=eids.device)
    src = torch.clamp(starts[:, None] + c[None, :], max=A - 1)
    slot_tok = torch.div(order[src], k, rounding_mode="floor")
    slot_ok = c[None, :] < counts[:, None]
    return slot_tok, slot_ok, slot, keep


def moe_apply(p: dict, s: MoESpec, x: torch.Tensor,
              no_drop: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (y, aux).  Assignments beyond an expert's capacity
    are dropped (``moe_capacity``; ``no_drop`` keeps every one, the
    decode setting).  Dispatch and combine are gathers (module
    docstring): no float atomics, the same bits every run."""
    B, S, D = x.shape
    T = B * S
    xt = x.reshape(T, D)
    gates, eids, aux = moe_route(p, s, xt)
    cap = moe_capacity(s, T, no_drop)
    slot_tok, slot_ok, slot, keep = moe_dispatch(s, eids, cap)
    buf = torch.where(slot_ok[..., None], xt[slot_tok], 0.0)   # (E, cap, D)
    # each expert's SwiGLU on its rows: three batched GEMMs
    w = p["experts"]
    h = F.silu(torch.bmm(buf, w["w_gate"])) * torch.bmm(buf, w["w_in"])
    out = torch.bmm(h, w["w_out"]).reshape(-1, D)
    # each token's k rows in ascending expert id, the reference's order
    # of its scatter-add
    perm = torch.argsort(eids, dim=-1)
    sl, kp = slot.gather(1, perm), keep.gather(1, perm)
    vals = torch.where(kp[..., None], out[sl], 0.0) \
        * gates.gather(1, perm).to(x.dtype)[..., None]       # (T, k, D)
    y = vals[:, 0]
    for j in range(1, s.top_k):
        y = y + vals[:, j]
    if "shared" in p:
        y = y + ffn_apply(p["shared"], "swiglu", x).reshape(T, D)
    return y.reshape(B, S, D), aux
