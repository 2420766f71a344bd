"""% of the window's solutions that replayed a drain from the program's
drain memo (``drain_memo_stats()`` hits over the window / solutions)."""


def read(rec):
    return 100.0 * rec.memo_hits / rec.completed if rec.completed else None
