"""Hand-written Hopper kernels (``csrc/*.cu``), their build (``build.py``),
their plain PyTorch versions (``ref.py``) and the public ops that pick
between them by the device of the tensors (``ops.py``)."""
