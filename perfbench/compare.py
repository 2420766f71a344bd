"""What the comparisons with the plain references share: the precision a
reference runs in, and blocks of matrices that fit beside each other."""

from __future__ import annotations

import contextlib
import math
from typing import Iterator, List, Sequence

import torch

# a block of float64 matrices for a reference run: about 2 GiB of inputs
BLOCK_BYTES = 2 << 30


def chunks(ids: Sequence[int], n: int) -> Iterator[List[int]]:
    """``ids`` in blocks of as many n x n float64 matrices as fit in
    ``BLOCK_BYTES`` (at least one)."""
    per = max(1, BLOCK_BYTES // (n * n * 8))
    ids = list(ids)
    for i in range(0, len(ids), per):
        yield ids[i : i + per]


def finite(x: float) -> float:
    """``x``, or infinity where it is NaN: a NaN answer is wrong."""
    return x if math.isfinite(x) else math.inf


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32's 10 bits of mantissa, to nearest."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A float32 product whose operands are first rounded to TF32, as the
    card's TF32 tensor cores take them."""
    return tf32_round(a) @ tf32_round(b)


@contextlib.contextmanager
def in_precision(precision: str, device: torch.device):
    """(dtype, matmul) of a reference run in ``precision``: ``float64``;
    ``float32`` (TF32 off); ``tf32``, float32 with TF32 products (the
    card's own on CUDA, ``tf32_matmul`` on the CPU)."""
    flag = torch.backends.cuda.matmul.allow_tf32
    try:
        if precision == "float64":
            yield torch.float64, torch.matmul
        elif precision == "float32":
            torch.backends.cuda.matmul.allow_tf32 = False
            yield torch.float32, torch.matmul
        elif precision == "tf32":
            torch.backends.cuda.matmul.allow_tf32 = True
            yield torch.float32, (torch.matmul if device.type == "cuda" else tf32_matmul)
        else:
            raise ValueError(f"precision {precision!r}: float64, float32 or tf32")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag
