"""The card's peaks that rooflines and MFU are taken against.

NVIDIA H100 SXM (data sheet, dense, at the 700 W limit): HBM3 at 3.35 TB/s;
TF32 tensor cores at 495 TFLOP/s.  A product at fp32 accuracy on the tensor
cores takes three TF32 products (3xTF32), so 495 / 3 = 165 TFLOP/s is the
fastest fp32-accurate route; the CUDA cores' plain fp32 (67 TFLOP/s) is
slower.  One figure for every kernel, whatever route it takes, so a
roofline share cannot move when only the implementation does.
"""

HBM_BYTES_PER_S = 3.35e12
FP32_ACCURATE_FLOPS_PER_S = 495e12 / 3


def bound_s(flops: float, nbytes: float) -> float:
    """Least time for ``flops`` and ``nbytes``: the larger of the two."""
    return max(flops / FP32_ACCURATE_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S)
