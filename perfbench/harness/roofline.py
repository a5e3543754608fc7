"""The yardstick of the LDL^T factors: the card's peaks and the least time
a factor could take.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at its 700 W limit):
67 TFLOP/s in float32 outside the tensor cores, 3.35 TB/s of HBM3.
"""

PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# the CUDA kernels of pygradflow_torch/csrc/ldlt.cu, by name
LDLT_KERNELS = (
    "pad_identity_kernel",
    "diag_block_kernel",
    "panel_rows_kernel",
    "trailing_update_kernel",
    "left_update_kernel",
)


def bound(shape):
    """Least time (s) the card could take to factor a matrix or stack of
    ``shape`` (..., n, n): the larger of n^3 / 3 FLOPs per matrix at the
    f32 peak and the input read once plus the factor written once (f32) at
    the memory rate; returns ``(seconds, "operations" | "bytes")``."""
    batch = 1
    for d in shape[:-2]:
        batch *= d
    n = shape[-1]
    flop_s = batch * n**3 / 3 / PEAK_F32_FLOPS
    byte_s = batch * 2 * 4 * n * n / PEAK_BYTES
    return (flop_s, "operations") if flop_s >= byte_s else (byte_s, "bytes")


def is_ldlt_kernel(name):
    return any(k in name for k in LDLT_KERNELS)
