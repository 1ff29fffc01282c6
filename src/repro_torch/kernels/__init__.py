"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

``ops`` dispatches by device: CPU tensors run ``ref``, CUDA tensors launch
the kernels of ``decode`` and ``fused_transform`` (built by ``build``).
"""
