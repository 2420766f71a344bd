"""The work of a tiled lower Cholesky factorization of n x n in p x p tiles
of t, counted over the algorithm's tasks: each task reads each of its input
tiles once and writes its output tile once, in float32 (4 bytes).

    POTRF(A_kk); TRSM(L_kk, A_ik) i > k; SYRK(A_ii -= L_ik L_ik^T) i > k;
    GEMM(A_ij -= L_ik L_jk^T) i > j > k

The kernel names are those the port's tile kernels carry in a device trace
(``potrf_kernel`` ...).  Nothing here reads what the program launched.
"""

from typing import List, Tuple

WORD = 4  # float32


def tasks(n: int, tile: int, rhs: int = 0) -> List[Tuple[str, int, float, float]]:
    """(kernel, tasks, FLOPs a task, bytes a task) for each kind of task."""
    if n % tile:
        raise ValueError(f"n={n} is not a multiple of the tile {tile}")
    p, t = n // tile, tile
    T = t * t * WORD
    tri = p * (p - 1) // 2
    return [
        ("potrf", p, t**3 / 3, 2 * T),
        ("trsm", tri, t**3, 3 * T),
        ("syrk", tri, t * t * (t + 1), 3 * T),
        ("gemm", p * (p - 1) * (p - 2) // 6, 2 * t**3, 4 * T),
    ]


def algorithmic_flops(n: int, rhs: int = 0) -> float:
    """LAPACK's count for the factorization: n^3/3."""
    return n**3 / 3
