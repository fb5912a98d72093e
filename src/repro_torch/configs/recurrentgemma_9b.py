"""recurrentgemma-9b — hybrid RG-LRU + local attention (2 recurrent :
1 local-attn), 38L d_model=4096 16H (MQA kv=1) d_ff=12288 vocab=256000,
window 2048, lru width 4096.  [arXiv:2402.19427 (Griffin); unverified]"""
from repro_torch.models.lm import LMConfig

# long_500k RUNS: recurrent state is O(1), local attention is O(window).
SKIPS = {}

_PATTERN = (("rglru", "dense"), ("rglru", "dense"), ("local", "dense"))


def config() -> LMConfig:
    return LMConfig(
        name="recurrentgemma-9b", n_layers=38, d_model=4096, n_heads=16,
        n_kv_heads=1, head_dim=256, d_ff=12288, vocab=256000,
        pattern=_PATTERN, window=2048, d_rnn=4096,
        ffn_kind="gelu", norm="rms", tie_embeddings=True)


def smoke_config() -> LMConfig:
    return LMConfig(
        name="recurrentgemma-smoke", n_layers=5, d_model=64, n_heads=4,
        n_kv_heads=1, head_dim=16, d_ff=128, vocab=128,
        pattern=_PATTERN, window=16, d_rnn=64,
        ffn_kind="gelu", norm="rms", tie_embeddings=True)
