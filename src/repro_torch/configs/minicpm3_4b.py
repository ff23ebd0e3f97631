"""minicpm3-4b [dense] — 62L d_model=2560 40H d_ff=6400 vocab=73448.
MLA attention (q_lora=768, kv_lora=256).  [hf:openbmb/MiniCPM3-4B]"""
from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    arch_id="minicpm3-4b",
    family="dense",
    n_layers=62,
    d_model=2560,
    d_ff=6400,
    vocab=73_448,
    citation="hf:openbmb/MiniCPM3-4B",
    norm="rms",
    tie_embeddings=True,
    attention=AttentionConfig(
        kind="mla", n_heads=40, n_kv_heads=40, head_dim=64,
        q_lora_rank=768, kv_lora_rank=256,
        rope_head_dim=32, nope_head_dim=64, v_head_dim=64,
        rope_theta=10_000.0,
    ),
)
