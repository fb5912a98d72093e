"""Recurrent blocks (port of ``repro.models.recurrent``): the RG-LRU of
RecurrentGemma / Griffin, and RWKV6 (Finch) time mix and channel mix.

**RG-LRU.**  h_t = a_t h_{t-1} + b_t per channel, with the decay
a_t = exp(-8 softplus(Lambda) r_t) and b_t = sqrt(1 - a_t^2) (i_t u_t).
The reference runs it with ``jax.lax.associative_scan``; ``_lru_scan``
here is a Hillis-Steele doubling over the time axis, ceil(log2 S)
passes of (a, b) <- (a a_shift, b a_shift + b_shift), which multiplies
decays directly.  It never forms a cumulative decay to divide by: at
the floor (Lambda = 6, r = 1) a token's log-decay is about -48, so a
chunk's product underflows to 0 and a factored exp(cumsum) form would
divide by it.  Decode is the same function at S = 1.

The WKV recurrence, per (batch, head), state S in R^{K x V}:

    o_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T ,   w_t = exp(logw_t) in (0, 1]

``wkv_naive`` is its sequential definition; ``wkv_chunked_ref`` the
factored chunk-parallel form the reference's LM path runs.  Both are
the plain versions of the CUDA kernel in ``kernels/wkv6``, which
``rwkv_time_mix`` reaches for CUDA tensors.

Numerical contract (as in the reference): per-channel log-decays are
clamped to >= LOG_DECAY_MIN so the factored chunk form stays in float32
range at WKV_CHUNK = 32 tokens (largest exponent 32 * |LOG_DECAY_MIN|).
At 128 tokens a chunk whose decays all sit at the clamp takes
exp(-cum) of values near 128, which overflows float32 to inf and then
NaN; so the chunk length here stays 32, and the CUDA kernel, which runs
the recurrence token by token, never forms exp(+-cum) at all.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.layers import _normal

LOG_DECAY_MIN = -1.0
WKV_CHUNK = 32


# ---------------------------------------------------------------------------
# RG-LRU (Griffin recurrent block)
# ---------------------------------------------------------------------------

def rglru_init(generator: torch.Generator, d_model: int, d_rnn: int,
               conv_width: int = 4, dtype=torch.bfloat16,
               device: DeviceLike = None) -> dict:
    """One RG-LRU mixer's weights, drawn from ``generator`` on ``device``
    (the card unless named); the reference's shapes, scales and dtypes
    (Lambda float32, spaced so the decay sits in [0.9, 0.999])."""
    device = resolve_device(device)
    sd, sr = 1.0 / math.sqrt(d_model), 1.0 / math.sqrt(d_rnn)

    def n(shape, scale):
        return _normal(generator, shape, scale, dtype, device)

    return {
        "w_x": n((d_model, d_rnn), sd),
        "w_y": n((d_model, d_rnn), sd),
        "conv_w": n((conv_width, d_rnn), 0.1),
        "w_rgate": n((d_rnn, d_rnn), sr),
        "w_igate": n((d_rnn, d_rnn), sr),
        "lam": torch.linspace(2.0, 6.0, d_rnn, dtype=torch.float32,
                              device=device),
        "w_out": n((d_rnn, d_model), sr),
    }


def _causal_conv(u: torch.Tensor, w: torch.Tensor,
                 state: Optional[torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv along S.  u: (B, S, R); w: (W, R); state:
    (B, W-1, R), the inputs before u.  The W taps are summed in order
    from tap 0, in u's dtype.  Returns (out, the last W-1 inputs)."""
    W, S = w.shape[0], u.shape[1]
    if state is None:
        state = torch.zeros((u.shape[0], W - 1, u.shape[2]), dtype=u.dtype,
                            device=u.device)
    ext = torch.cat([state.to(u.dtype), u], dim=1)      # (B, S+W-1, R)
    out = ext[:, 0:S] * w[0]
    for i in range(1, W):
        out = out + ext[:, i:i + S] * w[i]
    return out, ext[:, S:]


def _lru_scan(a: torch.Tensor, b: torch.Tensor,
              h0: Optional[torch.Tensor]) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t along axis 1 (h_{-1} = h0), by doubling:
    after the pass of shift d, (a_t, b_t) compose the up to 2d steps
    ending at t.  Decays are only multiplied (module docstring)."""
    if h0 is not None:                   # fold the initial state into b_0
        b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    S, d = a.shape[1], 1
    while d < S:
        a_r, b_r = a[:, d:], b[:, d:]
        b = torch.cat([b[:, :d], b[:, :-d] * a_r + b_r], dim=1)
        a = torch.cat([a[:, :d], a[:, :-d] * a_r], dim=1)
        d *= 2
    return b


def rglru_apply(p: dict, x: torch.Tensor, state: Optional[dict] = None
                ) -> Tuple[torch.Tensor, dict]:
    """x: (B, S, D) -> (out (B, S, D), new state {h, conv}).  The gates
    are float32 products, as in the reference; ``state`` None starts
    from zeros."""
    u = x @ p["w_x"]
    y = F.gelu(x @ p["w_y"], approximate="tanh")   # jax.nn.gelu's default
    u, new_conv = _causal_conv(u, p["conv_w"],
                               state["conv"] if state is not None else None)
    uf = u.float()
    r = torch.sigmoid(uf @ p["w_rgate"].float())
    i = torch.sigmoid(uf @ p["w_igate"].float())
    log_a = -8.0 * F.softplus(p["lam"]) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-6)) \
        * (i * uf)
    h = _lru_scan(a, b, state["h"] if state is not None else None)
    out = (h * y.float()).to(x.dtype) @ p["w_out"]
    return out, {"h": h[:, -1], "conv": new_conv}


def rglru_decode(p: dict, x: torch.Tensor, state: dict
                 ) -> Tuple[torch.Tensor, dict]:
    """Single-token step; x: (B, 1, D)."""
    return rglru_apply(p, x, state)


def rglru_state_init(batch: int, d_rnn: int, conv_width: int = 4,
                     dtype=torch.bfloat16, device: DeviceLike = None) -> dict:
    """Zero decode state on ``device`` (the card unless named): h float32
    (B, R), the conv's last inputs (B, W-1, R) in ``dtype``."""
    device = resolve_device(device)
    return {"h": torch.zeros((batch, d_rnn), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, conv_width - 1, d_rnn), dtype=dtype,
                                device=device)}


# ---------------------------------------------------------------------------
# RWKV6 time mix + channel mix
# ---------------------------------------------------------------------------

def rwkv_init(generator: torch.Generator, d_model: int, n_heads: int,
              d_ff: int, lora_rank: int = 64, dtype=torch.bfloat16,
              device: DeviceLike = None) -> dict:
    """One block's time-mix and channel-mix weights, drawn from
    ``generator`` (which must live on ``device``, the card unless
    named); the same shapes, scales and dtypes as the reference."""
    device = resolve_device(device)
    hd = d_model // n_heads
    sd = 1.0 / math.sqrt(d_model)
    f32 = dict(dtype=torch.float32, device=device)

    def n(shape, scale, dt=dtype):
        return _normal(generator, shape, scale, dt, device)

    return {
        "mu": torch.full((5, d_model), 0.5, **f32),   # r,k,v,g,w mixes
        "w_r": n((d_model, d_model), sd), "w_k": n((d_model, d_model), sd),
        "w_v": n((d_model, d_model), sd), "w_g": n((d_model, d_model), sd),
        "decay_w0": torch.full((d_model,), -1.5, **f32),
        "decay_a": n((d_model, lora_rank), sd),
        "decay_b": n((lora_rank, d_model), 0.01),
        "u": n((n_heads, hd), 0.1, torch.float32),
        "w_o": n((d_model, d_model), sd),
        "ln_scale": torch.ones((n_heads, hd), **f32),
        "ln_bias": torch.zeros((n_heads, hd), **f32),
        # channel mix
        "cm_mu": torch.full((2, d_model), 0.5, **f32),  # k, r mixes
        "cm_k": n((d_model, d_ff), sd),
        "cm_v": n((d_ff, d_model), 1.0 / math.sqrt(d_ff)),
        "cm_r": n((d_model, d_model), sd),
    }


def _token_shift(x: torch.Tensor,
                 last: Optional[torch.Tensor]) -> torch.Tensor:
    """x_{t-1} along S; ``last`` is the carried token for decode."""
    if last is None:
        last = torch.zeros_like(x[:, :1])
    else:
        last = last[:, None, :].to(x.dtype)
    return torch.cat([last, x[:, :-1]], dim=1)


def wkv_chunked_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    logw: torch.Tensor, u: torch.Tensor,
                    s0: Optional[torch.Tensor], chunk: int = WKV_CHUNK
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked WKV.  r, k, v, logw: (B, S, H, K) (logw <= 0, clamped);
    u: (H, K); s0: (B, H, K, V) or None.  Returns (o (B, S, H, V),
    s_end), float32."""
    B, S, H, K = r.shape
    C = min(chunk, S)
    pad = (-S) % C

    def prep(t):
        t = t.float()
        return F.pad(t, (0, 0, 0, 0, 0, pad)) if pad else t

    N = (S + pad) // C
    rs, ks, vs, lw = (prep(t).reshape(B, N, C, H, K)
                      for t in (r, k, v, logw))
    s = (torch.zeros((B, H, K, K), dtype=torch.float32, device=r.device)
         if s0 is None else s0.float())
    u = u.float()
    mask = torch.tril(torch.ones((C, C), dtype=torch.bool,
                                 device=r.device), diagonal=-1)
    outs = []
    for n in range(N):
        rc, kc, vc, lwc = rs[:, n], ks[:, n], vs[:, n], lw[:, n]  # (B,C,H,K)
        cum = torch.cumsum(lwc, dim=1)           # inclusive
        cum_ex = cum - lwc                       # exclusive
        total = cum[:, -1]                       # (B, H, K)
        q_t = rc * torch.exp(cum_ex)
        k_t = kc * torch.exp(-cum)
        inter = torch.einsum("bthk,bhkv->bthv", q_t, s)
        A = torch.einsum("bthk,bshk->bhts", q_t, k_t).masked_fill(
            ~mask, 0.0)
        intra = torch.einsum("bhts,bshv->bthv", A, vc)
        bonus = torch.einsum("bthk,hk,bthk->bth", rc, u, kc)
        outs.append(inter + intra + bonus[..., None] * vc)
        k_dec = kc * torch.exp(total[:, None] - cum)  # later decays
        s = s * torch.exp(total)[..., None] + \
            torch.einsum("bthk,bthv->bhkv", k_dec, vc)
    o = torch.stack(outs, dim=1).reshape(B, N * C, H, K)[:, :S]
    return o, s


def wkv_naive(r, k, v, logw, u, s0=None):
    """Exact sequential definition (tests)."""
    B, S, H, K = r.shape
    s = (torch.zeros((B, H, K, K), dtype=torch.float32, device=r.device)
         if s0 is None else s0.float())
    u = u.float()
    outs = []
    for t in range(S):
        rt, kt, vt = r[:, t].float(), k[:, t].float(), v[:, t].float()
        wt = torch.exp(logw[:, t].float())
        kv = torch.einsum("bhk,bhv->bhkv", kt, vt)
        outs.append(torch.einsum("bhk,bhkv->bhv", rt,
                                 s + u[None, :, :, None] * kv))
        s = s * wt[..., None] + kv
    return torch.stack(outs, dim=1), s


def rwkv_time_mix(p: dict, n_heads: int, x: torch.Tensor,
                  state: Optional[dict] = None,
                  use_kernel: bool = True) -> Tuple[torch.Tensor, dict]:
    """RWKV6 attention replacement.  x: (B, S, D).  With ``use_kernel``
    the WKV goes through ``kernels.wkv6.ops.wkv6`` (the CUDA kernel for
    CUDA tensors, ``wkv_chunked_ref`` for CPU ones); without it through
    ``wkv_chunked_ref`` on any device.  The kernel has no backward: asked
    for it while gradients flow, this raises (a train step passes
    ``use_kernel=False``)."""
    B, S, D = x.shape
    hd = D // n_heads
    last = state["x_tm"] if state is not None else None
    xp = _token_shift(x, last)
    mu = p["mu"].to(x.dtype)

    def mix(i):
        return x + mu[i] * (xp - x)

    r = (mix(0) @ p["w_r"]).reshape(B, S, n_heads, hd)
    k = (mix(1) @ p["w_k"]).reshape(B, S, n_heads, hd)
    v = (mix(2) @ p["w_v"]).reshape(B, S, n_heads, hd)
    g = mix(3) @ p["w_g"]
    lora = torch.tanh(mix(4) @ p["decay_a"]) @ p["decay_b"]
    logw = -torch.exp(p["decay_w0"].float() + lora.float())
    logw = torch.clamp(logw, min=LOG_DECAY_MIN).reshape(B, S, n_heads, hd)

    s0 = state["S"] if state is not None else None
    if use_kernel:
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (r, k, v, logw)):
            raise RuntimeError(
                "the WKV kernel has no backward: pass use_kernel=False "
                "(LMConfig.use_wkv_kernel) to differentiate the time mix")
        # imported here: kernels/wkv6/ref.py imports this module
        from repro_torch.kernels.wkv6 import ops as wkv_ops
        o, s_end = wkv_ops.wkv6(r, k, v, logw, p["u"], s0)
    else:
        o, s_end = wkv_chunked_ref(r, k, v, logw, p["u"], s0)

    # per-head layer norm
    mean = torch.mean(o, dim=-1, keepdim=True)
    var = torch.var(o, dim=-1, keepdim=True, unbiased=False)
    of = (o - mean) * torch.rsqrt(var + 1e-5)
    of = of * p["ln_scale"] + p["ln_bias"]
    o = of.reshape(B, S, D).to(x.dtype)
    out = (o * F.silu(g)) @ p["w_o"]
    return out, {"x_tm": x[:, -1], "S": s_end}


def rwkv_channel_mix(p: dict, x: torch.Tensor,
                     state: Optional[dict] = None
                     ) -> Tuple[torch.Tensor, dict]:
    last = state["x_cm"] if state is not None else None
    xp = _token_shift(x, last)
    mu = p["cm_mu"].to(x.dtype)
    xk = x + mu[0] * (xp - x)
    xr = x + mu[1] * (xp - x)
    h = torch.square(torch.relu(xk @ p["cm_k"]))
    hv = h @ p["cm_v"]
    rgate = torch.sigmoid(xr @ p["cm_r"])
    return rgate * hv, {"x_cm": x[:, -1]}


def rwkv_state_init(batch: int, d_model: int, n_heads: int,
                    dtype=torch.bfloat16, device: DeviceLike = None) -> dict:
    """Zero decode state of one block on ``device`` (the card unless
    named)."""
    device = resolve_device(device)
    hd = d_model // n_heads
    return {
        "x_tm": torch.zeros((batch, d_model), dtype=dtype, device=device),
        "x_cm": torch.zeros((batch, d_model), dtype=dtype, device=device),
        "S": torch.zeros((batch, n_heads, hd, hd), dtype=torch.float32,
                         device=device),
    }
