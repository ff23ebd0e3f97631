"""Config dataclasses of the port, copied from ``repro.configs.base``.

The LM model configs (``AttentionConfig``, ``MoEConfig``, ``SSMConfig``,
``RGLRUConfig``, ``EncoderConfig``, ``ModalityStub``, ``ModelConfig``,
``InputShape`` and ``INPUT_SHAPES``) are whole copies, so every arch of
the reference can be expressed, and the port's models run every one
of them (``repro_torch.models.model``).  The
communication configs (``CommConfig``, ``FabricConfig``,
``LinkConfig``) of the decentralized trainer follow, without the
deprecated flat-field properties.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class AttentionConfig:
    kind: str = "gqa"                 # "gqa" | "mla" | "none"
    n_heads: int = 8
    n_kv_heads: int = 8
    head_dim: int = 64
    qk_norm: bool = False             # qwen3-style per-head RMSNorm on q/k
    attn_softcap: Optional[float] = None   # gemma2 logit softcap
    rope_theta: float = 10_000.0
    sliding_window: Optional[int] = None   # window size for "local" layers
    # layer pattern, cycled over layers: entries "global" | "local"
    layer_pattern: Tuple[str, ...] = ("global",)
    # --- MLA (deepseek-v2 / minicpm3) ---
    q_lora_rank: Optional[int] = None
    kv_lora_rank: int = 512
    rope_head_dim: int = 64           # decoupled rope dims per head
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0                # routed experts (0 => dense FFN)
    n_shared: int = 0                 # always-on shared experts
    top_k: int = 2
    d_ff_expert: int = 0              # per-expert hidden dim
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001
    first_dense_layers: int = 1       # deepseek-v2: first layer(s) dense


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    n_heads: int = 24                 # SSD heads (d_inner / head_dim)
    head_dim: int = 64
    chunk: int = 256                  # SSD chunk length


@dataclass(frozen=True)
class RGLRUConfig:
    lru_width: int = 0                # 0 => d_model
    d_conv: int = 4
    block_pattern: Tuple[str, ...] = ("rglru", "rglru", "attn")  # 1:2 attn:rglru


@dataclass(frozen=True)
class EncoderConfig:
    """Encoder stack for enc-dec archs (seamless).  Frontend is stubbed:
    input_specs() provides precomputed frame embeddings (B, T_src, d_model)."""
    n_layers: int = 24
    n_frames: int = 1500              # encoder memory length for serve shapes
    d_model: int = 1024


@dataclass(frozen=True)
class ModalityStub:
    """VLM / audio frontend stub: precomputed patch/frame embeddings."""
    kind: str = "none"                # "none" | "vision" | "audio"
    n_tokens: int = 0                 # tokens contributed per sample
    feat_dim: int = 0                 # embedding dim provided by the frontend


@dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                       # dense|moe|ssm|hybrid|vlm|audio|cnn
    n_layers: int
    d_model: int
    d_ff: int
    vocab: int
    citation: str = ""
    norm: str = "rms"                 # rms | layer
    tie_embeddings: bool = True
    final_softcap: Optional[float] = None  # gemma2 final logit softcap
    attention: AttentionConfig = field(default_factory=AttentionConfig)
    moe: MoEConfig = field(default_factory=MoEConfig)
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    encoder: Optional[EncoderConfig] = None
    modality: ModalityStub = field(default_factory=ModalityStub)
    dtype: str = "bfloat16"
    # long-context policy: "native" (ssm/hybrid), "window" (ring-buffer
    # sliding-window decode cache), "skip"
    long_context: str = "window"
    long_window: int = 4096

    # ---- derived ----
    def block_kind(self, layer: int) -> str:
        """Which mixer this layer uses: attn | rglru | ssm, and local/global."""
        if self.family == "ssm":
            return "ssm"
        if self.rglru is not None:
            pat = self.rglru.block_pattern
            return pat[layer % len(pat)]
        return "attn"

    def attn_window(self, layer: int) -> Optional[int]:
        pat = self.attention.layer_pattern
        if pat[layer % len(pat)] == "local":
            return self.attention.sliding_window
        return None

    def n_params(self) -> int:
        """Total parameter count (approximate, embeddings included)."""
        d, L, V = self.d_model, self.n_layers, self.vocab
        a = self.attention
        total = V * d  # embedding
        if not self.tie_embeddings:
            total += V * d
        enc_layers = self.encoder.n_layers if self.encoder else 0
        for layer in range(L):
            kind = self.block_kind(layer)
            if kind == "ssm":
                assert self.ssm is not None
                d_in = self.ssm.expand * d
                total += d * 2 * d_in + d_in * d          # in/out proj
                total += d_in * (2 * self.ssm.d_state)     # B,C proj (per head shared)
                total += self.ssm.n_heads * 2              # A, dt bias
                total += self.ssm.d_conv * d_in
            elif kind == "rglru":
                assert self.rglru is not None
                w = self.rglru.lru_width or d
                total += d * w * 2 + w * d + 3 * w + self.rglru.d_conv * w
            else:  # attention
                if a.kind == "mla":
                    qd = a.q_lora_rank or 0
                    h = a.n_heads
                    qhead = a.nope_head_dim + a.rope_head_dim
                    if qd:
                        total += d * qd + qd * h * qhead
                    else:
                        total += d * h * qhead
                    total += d * (a.kv_lora_rank + a.rope_head_dim)
                    total += a.kv_lora_rank * h * (a.nope_head_dim + a.v_head_dim)
                    total += h * a.v_head_dim * d
                else:
                    total += d * a.n_heads * a.head_dim
                    total += 2 * d * a.n_kv_heads * a.head_dim
                    total += a.n_heads * a.head_dim * d
            # FFN / MoE
            m = self.moe
            if m.n_experts and layer >= m.first_dense_layers:
                total += (m.n_experts + m.n_shared) * 3 * d * m.d_ff_expert
                total += d * m.n_experts  # router
            else:
                ff = self.d_ff if not m.n_experts else self.d_ff
                total += 3 * d * ff  # gated MLP
            total += 2 * d  # norms
        for _ in range(enc_layers):
            ed = self.encoder.d_model
            total += 4 * ed * ed + 3 * ed * self.d_ff + 2 * ed
            total += 2 * ed * ed  # cross-attn kv in decoder (amortized rough)
        return total

    def n_active_params(self) -> int:
        """Active params per token (MoE: top_k + shared experts only)."""
        m = self.moe
        if not m.n_experts:
            return self.n_params()
        d, L = self.d_model, self.n_layers
        moe_layers = L - m.first_dense_layers
        inactive = (m.n_experts - m.top_k) * 3 * d * m.d_ff_expert * moe_layers
        return self.n_params() - inactive

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: ≤2 layers, d_model ≤ 512, ≤4 experts."""
        d = min(self.d_model, 256)
        a = self.attention
        heads = min(a.n_heads, 4) if a.n_heads else 0
        kv = max(1, min(a.n_kv_heads, heads)) if heads else 0
        red_attn = dataclasses.replace(
            a, n_heads=heads, n_kv_heads=kv,
            head_dim=max(16, d // heads) if heads else 0,
            q_lora_rank=(64 if a.q_lora_rank else None),
            kv_lora_rank=min(a.kv_lora_rank, 64),
            rope_head_dim=16, nope_head_dim=32, v_head_dim=32,
            sliding_window=(64 if a.sliding_window else None),
        )
        red_moe = dataclasses.replace(
            self.moe,
            n_experts=min(self.moe.n_experts, 4),
            n_shared=min(self.moe.n_shared, 1),
            top_k=min(self.moe.top_k, 2),
            d_ff_expert=(64 if self.moe.d_ff_expert else 0),
            first_dense_layers=min(self.moe.first_dense_layers, 1),
        )
        red_ssm = dataclasses.replace(
            self.ssm, d_state=16, n_heads=8,
            head_dim=self.ssm.expand * d // 8, chunk=32,
        ) if self.ssm else None
        red_rglru = dataclasses.replace(
            self.rglru, lru_width=(d if self.rglru.lru_width else 0),
        ) if self.rglru else None
        red_enc = dataclasses.replace(
            self.encoder, n_layers=1, n_frames=16, d_model=d,
        ) if self.encoder else None
        red_mod = dataclasses.replace(
            self.modality, n_tokens=min(self.modality.n_tokens, 8) or 0,
            feat_dim=(d if self.modality.feat_dim else 0),
        )
        return dataclasses.replace(
            self, n_layers=2, d_model=d, d_ff=min(self.d_ff, 512),
            vocab=min(self.vocab, 512),
            attention=red_attn, moe=red_moe, ssm=red_ssm, rglru=red_rglru,
            encoder=red_enc, modality=red_mod, dtype="float32",
            long_window=64,
        )


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    mode: str                         # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k":    InputShape("train_4k",    4_096,   256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768,   32, "prefill"),
    "decode_32k":  InputShape("decode_32k",  32_768,  128, "decode"),
    "long_500k":   InputShape("long_500k",  524_288,    1, "decode"),
}


@dataclass(frozen=True)
class LinkConfig:
    """Stochastic-link knobs (``repro_torch.topology.links.LinkModel``).

    ``model="sampled"`` draws per-edge, per-activation latency/bandwidth
    instead of the class constants — seeded + replayable; with all rates
    at zero the sampled ledger reproduces the constant ledger exactly."""
    model: str = "constant"           # constant | sampled
    jitter: float = 0.0               # per-activation lognormal sigma
    hetero: float = 0.0               # persistent per-edge base spread
    straggler_rate: float = 0.0       # P(normal -> slow) per activation
    straggler_exit: float = 0.5       # P(slow -> normal) per activation
    straggler_slowdown: float = 10.0  # lat x / bw / while slow


@dataclass(frozen=True)
class FabricConfig:
    """The communication fabric (``repro_torch.topology``): who talks to
    whom, when, at what link cost, and which nodes show up each round.

    Static graphs become constant schedules; tv-dcliques /
    random-matching are genuinely time-varying."""
    topology: str = "full"            # full | ring | torus | random |
    #                                   geo-wan | dcliques | hier-cliques |
    #                                   tv-dcliques | random-matching
    profile: str = "uniform"          # uniform | datacenter | geo-wan
    link: LinkConfig = field(default_factory=LinkConfig)
    # handshake amortization: a newly-activated link spreads its setup
    # latency over its first `amortize_window` gossip activations (1 =
    # pay up front); dropping a link forfeits the unpaid balance
    amortize_window: int = 1
    # online re-wiring: control-plane floats charged per newly-activated
    # link whenever the active edge set changes; 0 keeps re-wiring free
    # (the per-class handshake latency is still priced into simulated
    # time)
    rewire_floats: float = 0.0
    # client sampling / partial participation: each round a seeded
    # Bernoulli mask keeps this fraction of nodes in the gossip exchange
    # (local updates continue; an edge is active iff both endpoints
    # participate).  1.0 = everyone, every round.
    participation: float = 1.0


@dataclass(frozen=True)
class CommConfig:
    """The paper's technique as a first-class trainer feature: the
    strategy, its hyper-parameters, and the fabric (``fabric``) it runs
    over."""
    strategy: str = "bsp"             # bsp | gaia | fedavg | dgc | dpsgd |
    #                                   adpsgd
    fabric: FabricConfig = field(default_factory=FabricConfig)
    # asynchronous gossip (AD-PSGD): the ledger prices rounds on
    # per-edge virtual clocks instead of the slowest-link rule
    async_gossip: bool = False
    # snapshot-buffer depth for adpsgd
    max_staleness: int = 2
    # Gaia
    gaia_t0: float = 0.10
    # FedAvg
    iter_local: int = 20
    # DGC
    dgc_sparsity: float = 0.999       # final sparsity (top 0.1% exchanged)
    dgc_warmup_epochs: int = 4
    dgc_clip: float = 1.0
    dgc_compressor: str = "topk"      # topk | randk
    # SkewScout
    skewscout: bool = False
    travel_every: int = 500           # minibatches between model traveling
    sigma_al: float = 0.05
    lambda_al: float = 50.0
    lambda_c: float = 1.0
    tuner: str = "hill"               # hill | stochastic | anneal
