"""phi3-mini-3.8b — dense, 32L d_model=3072 32H (kv=32) d_ff=8192
vocab=32064, RoPE SwiGLU.  [arXiv:2404.14219; unverified]"""
from repro_torch.models.lm import LMConfig

SKIPS = {"long_500k": "pure full-attention arch — skip per the "
                      "sub-quadratic rule"}


def config() -> LMConfig:
    return LMConfig(
        name="phi3-mini-3.8b", n_layers=32, d_model=3072, n_heads=32,
        n_kv_heads=32, head_dim=96, d_ff=8192, vocab=32064,
        ffn_kind="swiglu", norm="rms")


def smoke_config() -> LMConfig:
    return LMConfig(
        name="phi3-mini-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=16, d_ff=128, vocab=128,
        ffn_kind="swiglu", norm="rms")
