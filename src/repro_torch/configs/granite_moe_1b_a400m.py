"""granite-moe-1b-a400m — MoE, 24L d_model=1024 16H (GQA kv=8) expert
d_ff=512 vocab=49155, 32 experts top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""
from repro_torch.models.lm import LMConfig

SKIPS = {"long_500k": "pure full-attention arch — skip per the "
                      "sub-quadratic rule"}


def config() -> LMConfig:
    return LMConfig(
        name="granite-moe-1b-a400m", n_layers=24, d_model=1024, n_heads=16,
        n_kv_heads=8, head_dim=64, d_ff=512, vocab=49155,
        pattern=(("attn", "moe"),),
        n_experts=32, top_k=8, moe_d_ff=512,
        ffn_kind="swiglu", norm="rms", tie_embeddings=True)


def smoke_config() -> LMConfig:
    return LMConfig(
        name="granite-moe-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=64, vocab=128,
        pattern=(("attn", "moe"),),
        n_experts=4, top_k=2, moe_d_ff=32,
        ffn_kind="swiglu", norm="rms", tie_embeddings=True)
