from repro_torch.core.algorithms.adpsgd import ADPSGD
from repro_torch.core.algorithms.base import ModelFns, tree_size
from repro_torch.core.algorithms.bsp import BSP
from repro_torch.core.algorithms.dgc import (DGC, WARMUP_SPARSITIES,
                                             warmup_sparsity)
from repro_torch.core.algorithms.dpsgd import DPSGD
from repro_torch.core.algorithms.fedavg import FedAvg
from repro_torch.core.algorithms.gaia import Gaia

__all__ = ["ADPSGD", "ModelFns", "tree_size", "BSP", "DGC",
           "WARMUP_SPARSITIES", "warmup_sparsity", "DPSGD", "FedAvg",
           "Gaia"]
