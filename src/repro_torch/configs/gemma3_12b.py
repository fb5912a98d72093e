"""gemma3-12b — dense, 48L d_model=3840 16H (GQA kv=8) d_ff=15360
vocab=262144, 5:1 local:global sliding-window attention (window 1024),
head_dim 256.  [hf:google/gemma-3-1b-pt family; unverified]"""
from repro_torch.models.lm import LMConfig

# long_500k RUNS: 40/48 layers are 1024-window local attention (ring
# cache) and only the 8 global layers pay O(S) decode — sub-quadratic
# in aggregate at decode time.
SKIPS = {}

_PATTERN = (("local", "dense"),) * 5 + (("attn", "dense"),)


def config() -> LMConfig:
    return LMConfig(
        name="gemma3-12b", n_layers=48, d_model=3840, n_heads=16,
        n_kv_heads=8, head_dim=256, d_ff=15360, vocab=262144,
        pattern=_PATTERN, window=1024, ffn_kind="gelu", norm="rms",
        rope_theta=1_000_000.0, tie_embeddings=True)


def smoke_config() -> LMConfig:
    return LMConfig(
        name="gemma3-12b-smoke", n_layers=6, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=128, vocab=128,
        pattern=_PATTERN, window=16, ffn_kind="gelu", norm="rms",
        tie_embeddings=True)
