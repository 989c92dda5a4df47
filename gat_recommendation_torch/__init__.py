"""gat_recommendation_torch — the session recommender in PyTorch for NVIDIA Hopper.

A second implementation of the JAX package beside it, with the same layout
(``data/``, ``ops/``, ``models/``, ``serving/``, ``train/``). Plain tensor code
is PyTorch; each Pallas kernel of the JAX package on a ported path becomes a
hand-written CUDA kernel for ``sm_90a`` (``csrc/``), built with ``nvcc`` at
first use (``ops/_build.py``). Every kernel wrapper runs its plain PyTorch
twin for CPU tensors, so the package imports and runs on a CPU-only host.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
