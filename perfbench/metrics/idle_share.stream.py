"""% of the window's wall time a solution in which the device ran nothing:
1 - the device's busy time a solution in the profiled stretch over the
unprofiled window's wall time a solution.  The profiler slows the host's
graph launches and not the kernels, so the stretch's own wall time would
count its slowdown as idle."""


def read(rec):
    if rec.trace is None or rec.trace.busy_s <= 0 or not rec.traced_answers or not rec.completed:
        return None
    return 100.0 * (1.0 - (rec.trace.busy_s / rec.traced_answers) / (rec.window_s / rec.completed))
