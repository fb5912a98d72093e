"""rwkv6-3b (Finch): attention-free linear recurrence, 32 layers,
d_model 2560 (40 heads x 64), d_ff 8960, vocab 65536, data-dependent
decay [arXiv:2404.05892].  Port of ``repro.configs.rwkv6_3b``; the WKV
recurrence is the hot spot (``kernels/wkv6``)."""
from repro_torch.models.lm import LMConfig

# long_500k runs: constant-size recurrent state.
SKIPS = {}


def config() -> LMConfig:
    return LMConfig(
        name="rwkv6-3b", n_layers=32, d_model=2560, n_heads=40,
        n_kv_heads=40, head_dim=64, d_ff=8960, vocab=65536,
        pattern=(("rwkv", "rwkv_cm"),), norm="ln")


def smoke_config() -> LMConfig:
    return LMConfig(
        name="rwkv6-3b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=16, d_ff=128, vocab=128,
        pattern=(("rwkv", "rwkv_cm"),), norm="ln")
