"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the
700 W power limit)."""

BF16_TENSOR_OPS_PER_S = 989e12      # bf16 and fp16 on the tensor cores
HBM_BYTES_PER_S = 3.35e12


def bound_s(ops: float, nbytes: float, ops_per_s: float = BF16_TENSOR_OPS_PER_S) -> float:
    """The least time the chip could take: the larger of the operation and
    the byte bound."""
    return max(ops / ops_per_s, nbytes / HBM_BYTES_PER_S)
