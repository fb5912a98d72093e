"""qwen2.5-3b — dense, 36L d_model=2048 16H (GQA kv=2) d_ff=11008
vocab=151936, QKV bias, tied embeddings.  [hf:Qwen/Qwen2.5-0.5B; hf]"""
from repro_torch.models.lm import LMConfig

SKIPS = {"long_500k": "pure full-attention arch — skip per the "
                      "sub-quadratic rule"}


def config() -> LMConfig:
    return LMConfig(
        name="qwen2.5-3b", n_layers=36, d_model=2048, n_heads=16,
        n_kv_heads=2, head_dim=128, d_ff=11008, vocab=151936,
        qkv_bias=True, ffn_kind="swiglu", norm="rms",
        rope_theta=1_000_000.0, tie_embeddings=True)


def smoke_config() -> LMConfig:
    return LMConfig(
        name="qwen2.5-3b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=128, vocab=128,
        qkv_bias=True, ffn_kind="swiglu", norm="rms",
        tie_embeddings=True)
