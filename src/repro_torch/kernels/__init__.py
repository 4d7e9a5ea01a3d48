"""Hand-written CUDA kernels of the port, their wrappers and plain versions.

Each wrapper module (``quant_matmul``, ``edge_softmax``, ``mddq_kernel``)
launches its kernel from ``csrc/`` on CUDA tensors and runs its plain
PyTorch version from ``ref`` on CPU tensors. ``ops`` holds the public
entry points the serving forward calls.
"""
