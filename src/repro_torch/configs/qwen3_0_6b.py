"""qwen3-0.6b [dense] — 28L d_model=1024 16H (GQA kv=8) d_ff=3072 vocab=151936.
qk_norm + GQA.  [hf:Qwen/Qwen3-8B]"""
from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen3-0.6b",
    family="dense",
    n_layers=28,
    d_model=1024,
    d_ff=3072,
    vocab=151_936,
    citation="hf:Qwen/Qwen3-8B",
    norm="rms",
    tie_embeddings=True,
    attention=AttentionConfig(
        kind="gqa", n_heads=16, n_kv_heads=8, head_dim=128,
        qk_norm=True, rope_theta=1_000_000.0,
    ),
)
