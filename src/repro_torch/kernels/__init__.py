"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (``ref.py`` collects those as oracles; ``ops.py`` holds the public
wrappers).  CUDA sources live in ``csrc/`` and build at first use
(``build.py``)."""
