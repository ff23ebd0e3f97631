"""Communication configs of the decentralized trainer: the strategy, its
hyper-parameters, and the fabric it runs over.  A copy of the
``CommConfig`` / ``FabricConfig`` / ``LinkConfig`` dataclasses of
``repro.configs.base`` without the LM model configs and without the
deprecated flat-field properties."""
from __future__ import annotations

from dataclasses import dataclass, field


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
