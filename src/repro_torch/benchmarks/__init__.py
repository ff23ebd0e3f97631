"""Benchmarks of the port: ``kernels_bench`` times every kernel op of
``repro_torch.kernels.ops`` beside its plain version and, where there is
one, the PyTorch call that computes the same function."""
