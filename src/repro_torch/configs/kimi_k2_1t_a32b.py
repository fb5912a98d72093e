"""kimi-k2-1t-a32b — MoE, 61L d_model=7168 64H (GQA kv=8) expert
d_ff=2048 vocab=163840, 384 experts top-8 + 1 shared, first layer dense
(DeepSeek-V3-style).  ~1.03T total / ~32B active params.
[arXiv:2501.kimi2 paper-table; unverified]"""
from repro_torch.models.lm import LMConfig

SKIPS = {"long_500k": "full-attention MoE — skip per the sub-quadratic "
                      "rule (all 61 layers pay O(S) decode)"}


def config() -> LMConfig:
    return LMConfig(
        name="kimi-k2-1t-a32b", n_layers=61, d_model=7168, n_heads=64,
        n_kv_heads=8, head_dim=112, d_ff=18432, vocab=163840,
        prefix=(("attn", "dense"),),           # layer 0 dense
        pattern=(("attn", "moe"),),            # layers 1..60 MoE
        n_experts=384, top_k=8, moe_d_ff=2048, shared_expert=True,
        ffn_kind="swiglu", norm="rms", rope_theta=50_000.0)


def smoke_config() -> LMConfig:
    return LMConfig(
        name="kimi-k2-smoke", n_layers=3, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=128, vocab=128,
        prefix=(("attn", "dense"),),
        pattern=(("attn", "moe"),),
        n_experts=4, top_k=2, moe_d_ff=32, shared_expert=True,
        ffn_kind="swiglu", norm="rms")
