"""The work of a pivot-free tiled LU factor-and-solve, ``a @ x == b`` with
``a`` of n x n in p x p tiles of t and ``b`` of n x c (c = 1: a vector),
counted over the algorithm's tasks: each task reads each of its input tiles
once and writes its output tile once, in float32 (4 bytes).

    factor:   GETRF(A_kk); TRSML(L_kk, A_kj) j > k; TRSMU(A_ik, U_kk) i > k;
              GEMMNN(A_ij -= A_ik A_kj) i, j > k
    forward:  TRSML(L_kk, b_k); GEMMNN(b_i -= L_ik b_k) i > k
    backward: TRSMUL(U_kk, b_k); GEMMNN(b_i -= U_ik b_k) i < k

The kernel names are those the port's tile kernels carry in a device trace
(``getrf_kernel`` ...).  Nothing here reads what the program launched.
"""

from typing import List, Tuple

WORD = 4  # float32


def tasks(n: int, tile: int, rhs: int = 1) -> List[Tuple[str, int, float, float]]:
    """(kernel, tasks, FLOPs a task, bytes a task) for each kind of task."""
    if n % tile:
        raise ValueError(f"n={n} is not a multiple of the tile {tile}")
    p, t, c = n // tile, tile, rhs
    T, V = t * t * WORD, t * c * WORD  # a tile of a, a tile of b
    tri = p * (p - 1) // 2
    return [
        ("getrf", p, 2 * t**3 / 3, 2 * T),
        ("trsml", tri, t**3, 3 * T),
        ("trsmu", tri, t**3, 3 * T),
        ("gemmnn", (p - 1) * p * (2 * p - 1) // 6, 2 * t**3, 4 * T),
        ("trsml", p, c * t * t, T + 2 * V),
        ("gemmnn", tri, 2 * t * t * c, T + 3 * V),
        ("trsmul", p, c * t * t, T + 2 * V),
        ("gemmnn", tri, 2 * t * t * c, T + 3 * V),
    ]


def algorithmic_flops(n: int, rhs: int = 1) -> float:
    """LAPACK's count for the factor and the two solves: 2n^3/3 + 2n^2 c."""
    return 2 * n**3 / 3 + 2 * n * n * rhs
