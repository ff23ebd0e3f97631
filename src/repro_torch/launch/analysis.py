"""Roofline terms of one rank's traced step (``repro.launch.analysis``).

  compute term    = flops            / peak FLOP/s
  memory term     = bytes            / HBM bandwidth
  collective term = collective bytes / link bandwidth

The reference reads its flops, bytes and collective bytes from the
compiled HLO, per device; here they are the counters of one rank's step
traced on ``meta`` tensors (``launch.meta``): ``CostMode``'s flops (the
formulas ``torch.utils.flop_counter`` registers, plus each kernel launch's
own: ``ops.attention_work`` for ``flash_attention``), its bytes (every
aten op's inputs and outputs counted on their own, so an upper bound on
the card's traffic, where the reference's are XLA's after fusion), and
the ``MetaMesh``'s collective records (the bytes a rank receives under
the ring algorithms, ``meta.wire_bytes``).

The rates are one NVIDIA H100 SXM's, from NVIDIA's H100 Tensor Core GPU
data sheet (SXM5 column, dense, no sparsity): 989 TFLOP/s of bfloat16 on
the tensor cores, 3.35 TB/s of HBM3, and NVLink 4 at 900 GB/s a GPU in
both directions, 450 GB/s each way.  As in the reference, one link rate
prices every collective, whichever axis it crosses (a pod axis between
hosts would ride a slower network than NVLink: the term is a lower
bound there).  The times are predictions at these rates, not
measurements.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

#: bfloat16 FLOP/s a card on the tensor cores, dense (H100 SXM data sheet)
BF16_FLOPS_PER_S = 989e12
#: bytes/s a card of HBM3 (H100 SXM data sheet)
HBM_BYTES_PER_S = 3.35e12
#: bytes/s a GPU of NVLink 4, one direction (900 GB/s both ways; data
#: sheet)
LINK_BYTES_PER_S = 450e9


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    n_chips: int
    hlo_gflops: float                    # one rank's
    hlo_gbytes: float
    coll_gbytes: float
    coll_breakdown: Dict[str, float]
    t_compute: float                     # seconds
    t_memory: float
    t_collective: float
    bottleneck: str
    model_gflops: float                  # 6*N*D (or 6*N_active*D), a rank
    useful_ratio: float                  # model_flops / traced flops
    bytes_per_device: Optional[float] = None
    note: str = ""

    def table_row(self) -> str:
        return (f"| {self.arch} | {self.shape} | {self.mesh} | "
                f"{self.t_compute*1e3:.2f} | {self.t_memory*1e3:.2f} | "
                f"{self.t_collective*1e3:.2f} | {self.bottleneck} | "
                f"{self.useful_ratio:.2f} |")


def derive_roofline(arch: str, shape: str, mesh_name: str, n_chips: int,
                    flops: float, n_bytes: float,
                    colls: Dict[str, float], model_flops: float,
                    bytes_per_device: Optional[float] = None,
                    note: str = "") -> Roofline:
    """The three terms of one rank: ``flops`` and ``n_bytes`` its traced
    step's (``CostMode``), ``colls`` its collectives' wire bytes by kind
    (the reference's names: ``all-reduce``, ``all-gather``, ...),
    ``model_flops`` the whole
    step's (``model_flops_estimate``), of which a rank does its 1 /
    ``n_chips``."""
    coll_total = float(sum(colls.values()))
    t_c = flops / BF16_FLOPS_PER_S
    t_m = n_bytes / HBM_BYTES_PER_S
    t_x = coll_total / LINK_BYTES_PER_S
    terms = {"compute": t_c, "memory": t_m, "collective": t_x}
    bottleneck = max(terms, key=terms.get)
    per_dev_model_flops = model_flops / n_chips
    return Roofline(
        arch=arch, shape=shape, mesh=mesh_name, n_chips=n_chips,
        hlo_gflops=flops / 1e9, hlo_gbytes=n_bytes / 1e9,
        coll_gbytes=coll_total / 1e9,
        coll_breakdown={k: v / 1e9 for k, v in colls.items()},
        t_compute=t_c, t_memory=t_m, t_collective=t_x,
        bottleneck=bottleneck,
        model_gflops=per_dev_model_flops / 1e9,
        useful_ratio=(per_dev_model_flops / flops) if flops else 0.0,
        bytes_per_device=bytes_per_device,
        note=note)


def model_flops_estimate(cfg, shape, mode: str) -> float:
    """MODEL_FLOPS = 6*N*D for training, 2*N*D for inference
    (N = active params, D = tokens processed)."""
    n_active = cfg.n_active_params()
    if mode == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if mode == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    tokens = shape.global_batch                      # one token per request
    return 2.0 * n_active * tokens
