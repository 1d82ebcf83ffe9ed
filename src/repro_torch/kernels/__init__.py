"""Hopper kernels of the port and their plain PyTorch versions: the matmul
(``csrc/matmul.cu``) and the bitonic sort (``csrc/bitonic_sort.cu``)."""
