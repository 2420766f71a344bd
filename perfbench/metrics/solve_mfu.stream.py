"""% of the card's fp32-accurate peak (165 TFLOP/s) that the operation's
algorithmic FLOPs a solution reach at the window's time per solution
(``reduce.solve_mfu``)."""

from perfbench.reduce import solve_mfu


def read(rec):
    return solve_mfu(rec)
