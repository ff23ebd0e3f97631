"""mamba2-780m [ssm] — 48L d_model=1536 (attention-free) vocab=50280,
ssm_state=128.  SSD (state-space duality), chunked dual form.
[arXiv:2405.21060]"""
from repro_torch.configs.base import AttentionConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    d_ff=0,
    vocab=50_280,
    citation="arXiv:2405.21060",
    norm="rms",
    tie_embeddings=True,
    long_context="native",
    attention=AttentionConfig(kind="none", n_heads=0, n_kv_heads=0, head_dim=0),
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, n_heads=48, head_dim=64,
                  chunk=256),
)
