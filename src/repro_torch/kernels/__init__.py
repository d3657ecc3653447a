"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

``distance_tile`` (K1/K2), ``dense_tile`` (K3/K4) and ``flash_attention``
(K5) wrap the CUDA C++ in ``csrc/``, built by ``_build`` at first use;
``ops`` dispatches between the tile kernels and ``ref`` holds the oracles
(direct-form distances, dense softmax attention).
"""
