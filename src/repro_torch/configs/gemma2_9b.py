"""gemma2-9b [dense] — 42L d_model=3584 16H (GQA kv=8) d_ff=14336
vocab=256000.  Local+global alternating attention, logit softcaps.
[arXiv:2408.00118]"""
from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    arch_id="gemma2-9b",
    family="dense",
    n_layers=42,
    d_model=3584,
    d_ff=14_336,
    vocab=256_000,
    citation="arXiv:2408.00118",
    norm="rms",
    tie_embeddings=True,
    final_softcap=30.0,
    attention=AttentionConfig(
        kind="gqa", n_heads=16, n_kv_heads=8, head_dim=256,
        attn_softcap=50.0, sliding_window=4096,
        layer_pattern=("local", "global"), rope_theta=10_000.0,
    ),
)
