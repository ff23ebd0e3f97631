from repro_torch.configs.base import CommConfig, FabricConfig, LinkConfig
from repro_torch.configs.cnn_zoo import CNN_ZOO, CNNConfig

__all__ = ["CommConfig", "FabricConfig", "LinkConfig", "CNN_ZOO",
           "CNNConfig"]
