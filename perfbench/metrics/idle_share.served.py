"""% of the profiled stretch in which the device ran nothing
(``reduce.idle_share``)."""

from perfbench.reduce import idle_share


def read(rec):
    return idle_share(rec)
