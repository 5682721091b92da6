"""PyTorch/CUDA port of the Pair-Net framework in ``pairnet_tpu``.

The JAX package stays the reference; this package computes the same
functions with PyTorch and hand-written CUDA kernels for Hopper (sm_90a).
It imports neither JAX nor anything of ``pairnet_tpu``.
"""
