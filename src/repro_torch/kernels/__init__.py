"""Hopper kernels of the port and their plain PyTorch versions: the matmul
(``csrc/matmul.cu``), the bitonic sort (``csrc/bitonic_sort.cu``) and flash
attention, forward and backward (``csrc/flash_attention.cu``)."""
