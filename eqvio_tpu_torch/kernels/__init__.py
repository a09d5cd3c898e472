"""Hand-written CUDA kernels of the port, each beside its plain PyTorch version.

Sources live in ``eqvio_tpu_torch/csrc``; :mod:`.build` compiles them with
``nvcc`` for ``sm_90a`` on first use into the repository's ``build/kernels``
directory and loads them with ctypes.
"""
