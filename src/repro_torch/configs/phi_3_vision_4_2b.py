"""phi-3-vision-4.2b [vlm] — 32L d_model=3072 32H (GQA kv=32) d_ff=8192
vocab=32064.  phi3-mini backbone + CLIP frontend (stubbed patch embeddings).
[hf:microsoft/Phi-3-vision-128k-instruct]"""
from repro_torch.configs.base import AttentionConfig, ModalityStub, ModelConfig

CONFIG = ModelConfig(
    arch_id="phi-3-vision-4.2b",
    family="vlm",
    n_layers=32,
    d_model=3072,
    d_ff=8192,
    vocab=32_064,
    citation="hf:microsoft/Phi-3-vision-128k-instruct",
    norm="rms",
    tie_embeddings=False,
    attention=AttentionConfig(
        kind="gqa", n_heads=32, n_kv_heads=32, head_dim=96,
        rope_theta=10_000.0,
    ),
    # CLIP ViT-L/14 @336px => 576 patch tokens, 1024-d features, projected
    # into the LM by a learned projector (part of our backbone).
    modality=ModalityStub(kind="vision", n_tokens=576, feat_dim=1024),
)
