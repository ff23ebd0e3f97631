from repro_torch.data.pipeline import DecentralizedLoader, PartitionLoader
from repro_torch.data.synthetic import (ImageDataset, TokenDataset,
                                        synth_geo_images, synth_images,
                                        synth_tokens)

__all__ = ["DecentralizedLoader", "PartitionLoader", "ImageDataset",
           "TokenDataset", "synth_geo_images", "synth_images", "synth_tokens"]
