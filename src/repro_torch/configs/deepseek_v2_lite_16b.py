"""deepseek-v2-lite-16b [moe] — 27L d_model=2048 16H d_ff=1408 (per expert)
vocab=102400.  MLA kv_lora=512 (no q_lora), MoE: 2 shared + 64 routed, top-6.
[arXiv:2405.04434]"""
from repro_torch.configs.base import AttentionConfig, MoEConfig, ModelConfig

CONFIG = ModelConfig(
    arch_id="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    d_ff=10_944,                 # dense FFN width for the first (dense) layer
    vocab=102_400,
    citation="arXiv:2405.04434",
    norm="rms",
    tie_embeddings=False,
    attention=AttentionConfig(
        kind="mla", n_heads=16, n_kv_heads=16, head_dim=128,
        q_lora_rank=None, kv_lora_rank=512,
        rope_head_dim=64, nope_head_dim=128, v_head_dim=128,
        rope_theta=10_000.0,
    ),
    moe=MoEConfig(
        n_experts=64, n_shared=2, top_k=6, d_ff_expert=1408,
        capacity_factor=1.25, router_aux_weight=0.001, first_dense_layers=1,
    ),
)
