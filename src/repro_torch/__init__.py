"""PyTorch/CUDA port of the decentralized-learning reproduction.

Mirrors the module layout of ``repro`` (the JAX reference) and imports
nothing of it or of JAX.  Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``; the hand-written Hopper kernels live under
``kernels/csrc`` and are built at first use by ``kernels/build.py``.
"""
