"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit): the yardstick of every roofline
share. A share is the least time the card could take for the work, the
larger of operations over the rate and bytes over the memory rate, over
the time the work took."""

BYTES_PER_S = 3.35e12          # HBM3
FLOP_PER_S = {
    "float32": 67e12,          # outside the tensor cores
    "float64": 67e12,          # the tensor cores' FP64 rate
    "tf32": 495e12,
    "bfloat16": 989e12,
}


def bound_s(flops: float, nbytes: float, dtype: str) -> float:
    """The least seconds the card could take for the work."""
    return max(flops / FLOP_PER_S[dtype], nbytes / BYTES_PER_S)
