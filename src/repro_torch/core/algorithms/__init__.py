from repro_torch.core.algorithms.base import ModelFns, tree_size
from repro_torch.core.algorithms.bsp import BSP
from repro_torch.core.algorithms.dpsgd import DPSGD
from repro_torch.core.algorithms.gaia import Gaia

__all__ = ["ModelFns", "tree_size", "BSP", "DPSGD", "Gaia"]
