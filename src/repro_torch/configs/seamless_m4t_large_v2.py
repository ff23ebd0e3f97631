"""seamless-m4t-large-v2 [audio] — 24L d_model=1024 16H (GQA kv=16) d_ff=8192
vocab=256206.  Encoder-decoder, multimodal; mel/conv frontend stubbed —
input_specs() provides precomputed frame embeddings.  [arXiv:2308.11596]"""
from repro_torch.configs.base import (AttentionConfig, EncoderConfig, ModalityStub,
                                ModelConfig)

CONFIG = ModelConfig(
    arch_id="seamless-m4t-large-v2",
    family="audio",
    n_layers=24,
    d_model=1024,
    d_ff=8192,
    vocab=256_206,
    citation="arXiv:2308.11596",
    norm="layer",
    tie_embeddings=True,
    attention=AttentionConfig(
        kind="gqa", n_heads=16, n_kv_heads=16, head_dim=64,
        rope_theta=10_000.0,
    ),
    encoder=EncoderConfig(n_layers=24, n_frames=1500, d_model=1024),
    modality=ModalityStub(kind="audio", n_tokens=1500, feat_dim=1024),
)
