"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

``distance_tile`` (K1/K2) and ``dense_tile`` (K3/K4) wrap the CUDA C++ in
``csrc/``, built by ``_build`` at first use; ``ops`` dispatches between them
and ``ref`` holds the direct-form oracles.
"""
