"""chameleon-34b — VLM early-fusion, 48L d_model=8192 64H (GQA kv=8)
d_ff=22016 vocab=65536.  VQ image tokens are ordinary tokens in the
unified vocabulary (the VQ tokenizer frontend is a stub: input_specs()
provides already-tokenized mixed text+image streams).
[arXiv:2405.09818; unverified]"""
from repro_torch.models.lm import LMConfig

SKIPS = {"long_500k": "pure full-attention arch — skip per the "
                      "sub-quadratic rule"}


def config() -> LMConfig:
    return LMConfig(
        name="chameleon-34b", n_layers=48, d_model=8192, n_heads=64,
        n_kv_heads=8, head_dim=128, d_ff=22016, vocab=65536,
        ffn_kind="swiglu", norm="rms")


def smoke_config() -> LMConfig:
    return LMConfig(
        name="chameleon-34b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=128, vocab=128,
        ffn_kind="swiglu", norm="rms")
