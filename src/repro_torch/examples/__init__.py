"""Examples of the port, run as ``python -m repro_torch.examples.<name>``."""
