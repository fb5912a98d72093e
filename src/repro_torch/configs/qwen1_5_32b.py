"""qwen1.5-32b — dense, 64L d_model=5120 40H (MHA kv=40) d_ff=27392
vocab=152064, QKV bias.  [hf:Qwen/Qwen1.5-0.5B family; hf]"""
from repro_torch.models.lm import LMConfig

SKIPS = {"long_500k": "pure full-attention arch: 500k decode cache is "
                      "O(S) per layer for all 64 layers — sub-quadratic "
                      "rule says skip (see DESIGN.md §Arch-applicability)"}


def config() -> LMConfig:
    return LMConfig(
        name="qwen1.5-32b", n_layers=64, d_model=5120, n_heads=40,
        n_kv_heads=40, head_dim=128, d_ff=27392, vocab=152064,
        qkv_bias=True, ffn_kind="swiglu", norm="rms",
        rope_theta=1_000_000.0)


def smoke_config() -> LMConfig:
    return LMConfig(
        name="qwen1.5-32b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=16, d_ff=128, vocab=128,
        qkv_bias=True, ffn_kind="swiglu", norm="rms")
