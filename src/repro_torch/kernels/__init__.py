"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

``ops`` dispatches by device: CPU tensors run ``ref``, CUDA tensors launch
the kernels of ``decode``, ``fused_transform``, ``embedding_bag``,
``flash_attention``, ``ssd_chunk``, ``sigrid_hash`` and ``bucketize``
(built by ``build``).
"""
