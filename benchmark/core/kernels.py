"""Which device kernels belong to which layer, by name (frozen with the
benchmark, so that a program change cannot move a kernel between layers)."""

import re

# K1, the spatial-cls table kernel (kstar_torch/csrc/spatial_table.cu):
# every instance's symbol carries the source's name
K1 = re.compile(r"spatial_table")
# convolutions on cuDNN and the 1x1x1 convolutions and Dense layers as GEMMs
# (cuBLAS, cuBLASLt, CUTLASS); not cuDNN's layout conversions and padding
CONV = re.compile(r"fprop|implicit_gemm|implicit_convolve|winograd|gemm|nvjet|splitKreduce")
LAYOUT = re.compile(r"nchwToNhwc|nhwcToNchw|AddPadding")
COPY = ("Memcpy", "Memset")


def is_k1(name: str) -> bool:
    return bool(K1.search(name))


def is_conv(name: str) -> bool:
    return bool(CONV.search(name)) and not LAYOUT.search(name)
