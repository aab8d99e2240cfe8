"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the full 700 W power limit), and the least time a piece of work could
take on it."""

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12  # float32 outside the tensor cores (the program runs with TF32 off)


def bound_s(n_bytes: float, flops: float) -> float:
    """The larger of bytes over the memory bandwidth and operations over the
    float32 peak."""
    return max(n_bytes / HBM_BYTES_PER_S, flops / FP32_FLOPS)
