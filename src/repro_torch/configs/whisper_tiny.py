"""whisper-tiny — audio enc-dec, 4L enc + 4L dec, d_model=384 6H
d_ff=1536 vocab=51865.  Conv audio frontend is a STUB: the encoder
takes precomputed (B, 1500, 384) frame embeddings.
[arXiv:2212.04356; unverified]"""
from repro_torch.models.encdec import EncDecConfig

SKIPS = {"long_500k": "full-attention enc-dec — skip per the "
                      "sub-quadratic rule"}


def config() -> EncDecConfig:
    return EncDecConfig(
        name="whisper-tiny", n_enc_layers=4, n_dec_layers=4,
        d_model=384, n_heads=6, d_ff=1536, vocab=51865,
        max_source=1500, max_target=448)


def smoke_config() -> EncDecConfig:
    return EncDecConfig(
        name="whisper-tiny-smoke", n_enc_layers=2, n_dec_layers=2,
        d_model=64, n_heads=4, d_ff=128, vocab=128,
        max_source=32, max_target=32)
