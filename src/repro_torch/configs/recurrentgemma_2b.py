"""recurrentgemma-2b [hybrid] — 26L d_model=2560 10H (GQA kv=1) d_ff=7680
vocab=256000.  RG-LRU + local attention, 1 attn : 2 recurrent.
[arXiv:2402.19427]"""
from repro_torch.configs.base import AttentionConfig, ModelConfig, RGLRUConfig

CONFIG = ModelConfig(
    arch_id="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    d_ff=7680,
    vocab=256_000,
    citation="arXiv:2402.19427",
    norm="rms",
    tie_embeddings=True,
    long_context="native",
    attention=AttentionConfig(
        kind="gqa", n_heads=10, n_kv_heads=1, head_dim=256,
        sliding_window=2048, layer_pattern=("local",),
        rope_theta=10_000.0,
    ),
    rglru=RGLRUConfig(lru_width=2560, d_conv=4,
                      block_pattern=("rglru", "rglru", "attn")),
)
