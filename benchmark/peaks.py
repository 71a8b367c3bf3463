"""Published peaks of one NVIDIA H100 SXM (NVIDIA's H100 data sheet: dense
rates, no sparsity, at the full 700 W power limit). A card set below
700 W runs slower under load; every run prints its power limit beside
the shares computed against these."""

FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # tensor-core bf16; fp32 off the tensor cores
BYTES_PER_S = 3.35e12                              # HBM3


def bound_s(flops_by_dtype: dict, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations over
    their precision's peak and the bytes over the memory bandwidth."""
    ops = sum(f / FLOPS[dtype] for dtype, f in flops_by_dtype.items())
    return max(ops, nbytes / BYTES_PER_S)
