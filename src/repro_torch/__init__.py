"""repro_torch: the similarity self-join on PyTorch and hand-written CUDA.

The PyTorch port of the JAX package ``repro`` (Gowanlock & Karsin 2018,
"GPU Accelerated Similarity Self-Join for Multi-Dimensional Data").  The
host side (REORDER, grid, tile plan, cost model) is numpy; the device side
runs on one NVIDIA H100 through the CUDA C++ kernels in ``csrc/``, built
with ``nvcc`` at first use.  Entry points take ``device=`` and default to
``"cuda"``; they raise when no card is present unless ``device="cpu"`` is
given, in which case every kernel runs its plain PyTorch version.

This package imports ``torch`` and numpy, never ``jax`` and nothing of
``repro``.
"""

__version__ = "0.1.0"
