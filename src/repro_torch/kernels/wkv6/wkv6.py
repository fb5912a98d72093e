"""CUDA WKV6 kernel for Hopper and its wrapper (port of the Pallas kernel
``repro.kernels.wkv6.wkv6.wkv6_pallas``).

The kernel, in ``csrc/wkv6.cu``, runs the recurrence token by token in
float32: each lane holds a tile of rows x columns of the state in
registers (the source picks the tile from the head size and the call's
length), the lanes sharing columns join their partial outputs with
shuffles, a block owns a group of columns of one (batch, head), and the
inputs stream through a ring of shared-memory chunks of 16 tokens
(``cp.async``, one barrier per chunk); a call of at most two tokens (a
decode step) reads its tokens straight from device memory, with a tile
of its own.  Unlike the reference's chunked form it never
exponentiates a cumulative log-decay, so it stays finite at the decay
clamp for any sequence length, and it needs no padding.  See the source
for what bounds it.

The wrapper takes the plain version (``ref.wkv_chunked`` at the
reference LM's chunk of ``WKV_CHUNK`` tokens) only for tensors on the
CPU; for CUDA tensors it launches the kernel or raises, and adds one to
its count in ``LIBRARY`` where it launches.
"""
from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import torch

from repro_torch.kernels.build import KernelLibrary, check_rc, stream
from repro_torch.kernels.wkv6 import ref

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                      "wkv6.cu")
# head sizes the kernel is instantiated for (its state rows live in
# registers, so K is a compile-time constant): rwkv6's 64, the smoke
# config's 16, and 32, each run by the gpu tests
HEAD_SIZES = (16, 32, 64)
INPUT_DTYPES = (torch.float32, torch.bfloat16)


def _bind(lib: ctypes.CDLL) -> None:
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.wkv6_launch.argtypes = [vp] * 8 + [i] * 5 + [vp]
    lib.wkv6_launch.restype = i


LIBRARY = KernelLibrary(SOURCE, ("wkv6",), _bind)
build = LIBRARY.load
reset_launch_counts = LIBRARY.reset_counts
launch_counts = LIBRARY.counts


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32).contiguous()


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it that starts on a 16-byte boundary."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         logw: torch.Tensor, u: torch.Tensor,
         s0: Optional[torch.Tensor] = None
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, logw: (B, S, H, K); u: (H, K); s0: (B, H, K, K) or None.
    Returns (o (B, S, H, K), s_end (B, H, K, K)), both float32."""
    dev = r.device
    for name, t in (("k", k), ("v", v), ("logw", logw), ("u", u),
                    ("s0", s0)):
        if t is not None and t.device != dev:
            raise ValueError(f"{name} on {t.device}, r on {dev}")
    if dev.type == "cpu":
        return ref.wkv_chunked(r, k, v, logw, u, s0)
    if dev.type != "cuda":
        raise ValueError(f"no WKV6 kernel for device {dev}")

    if r.dim() != 4 or k.shape != r.shape or v.shape != r.shape or \
            logw.shape != r.shape:
        raise ValueError("want r, k, v, logw of one shape (B, S, H, K)")
    B, S, H, K = r.shape
    if min(B, S, H) < 1:
        raise ValueError(f"empty WKV input of shape {tuple(r.shape)}")
    if K not in HEAD_SIZES:
        raise ValueError(f"head size {K} not in {HEAD_SIZES}")
    if r.dtype not in INPUT_DTYPES or k.dtype != r.dtype or \
            v.dtype != r.dtype:
        raise TypeError(f"r, k, v must share one dtype of {INPUT_DTYPES}")
    if tuple(u.shape) != (H, K):
        raise ValueError(f"u of shape {tuple(u.shape)}, want {(H, K)}")
    if s0 is not None and tuple(s0.shape) != (B, H, K, K):
        raise ValueError(f"s0 of shape {tuple(s0.shape)}, want "
                         f"{(B, H, K, K)}")
    # the kernel copies r, k, v, logw and reads s0 16 bytes at a time
    r, k, v, logw = (_aligned(t.contiguous()) for t in (r, k, v, _f32(logw)))
    u = _f32(u)
    s0 = _aligned(_f32(s0)) if s0 is not None else None
    o = torch.empty((B, S, H, K), dtype=torch.float32, device=dev)
    s_end = torch.empty((B, H, K, K), dtype=torch.float32, device=dev)
    lib = build()
    with torch.cuda.device(dev):
        rc = lib.wkv6_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
            u.data_ptr(), s0.data_ptr() if s0 is not None else None,
            o.data_ptr(), s_end.data_ptr(), B, S, H, K,
            int(r.dtype == torch.bfloat16), stream(dev))
    check_rc(rc, "wkv6")
    LIBRARY.count("wkv6")
    return o, s_end
