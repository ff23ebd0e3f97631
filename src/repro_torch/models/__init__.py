from repro_torch.models.cnn import (cnn_apply, cnn_batch_stats,
                                    cnn_params_from_jax, init_cnn)

__all__ = ["cnn_apply", "cnn_batch_stats", "cnn_params_from_jax", "init_cnn"]
