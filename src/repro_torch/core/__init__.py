from repro_torch.core.partition import (label_distribution, partition_80_20,
                                        partition_by_region,
                                        partition_label_skew, skew_index)
from repro_torch.core.skewscout import THETA_LADDERS, SkewScout
from repro_torch.core.trainer import (RunResult, make_algorithm, make_cnn_fns,
                                      train_decentralized)

__all__ = ["label_distribution", "partition_80_20", "partition_by_region",
           "partition_label_skew", "skew_index", "SkewScout",
           "THETA_LADDERS", "RunResult",
           "make_algorithm", "make_cnn_fns", "train_decentralized"]
