"""Time to a solution for one client that waits for each: the window's wall
time over the answers completed in it (host clock)."""


def read(rec):
    return rec.window_s / rec.completed * 1e3 if rec.completed else None
