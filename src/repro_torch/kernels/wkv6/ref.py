"""Plain PyTorch versions of the RWKV6 WKV recurrence (port of
``repro.kernels.wkv6.ref``): ``wkv_naive``, the sequential definition,
and ``wkv_chunked``, the factored chunk form.  Both live in
``repro_torch.models.recurrent``; see there for the recurrence and the
chunk-length contract."""
from repro_torch.models.recurrent import wkv_chunked_ref, wkv_naive

wkv_chunked = wkv_chunked_ref

__all__ = ["wkv_naive", "wkv_chunked"]
