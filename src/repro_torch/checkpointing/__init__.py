from repro_torch.checkpointing.checkpoint import (latest_step, load_meta,
                                                  restore, save)

__all__ = ["latest_step", "load_meta", "restore", "save"]
