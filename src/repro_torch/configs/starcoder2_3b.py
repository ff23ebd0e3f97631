"""starcoder2-3b [dense] — 30L d_model=3072 24H (GQA kv=2) d_ff=12288
vocab=49152.  GQA + RoPE, native sliding-window 4096.  [arXiv:2402.19173]"""
from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    arch_id="starcoder2-3b",
    family="dense",
    n_layers=30,
    d_model=3072,
    d_ff=12_288,
    vocab=49_152,
    citation="arXiv:2402.19173",
    norm="layer",
    tie_embeddings=True,
    attention=AttentionConfig(
        kind="gqa", n_heads=24, n_kv_heads=2, head_dim=128,
        sliding_window=4096, layer_pattern=("local",),
        rope_theta=100_000.0,
    ),
)
