"""Process start to the first timed operation: imports, inputs made on the
device, planning, capture and warm-up (host clock)."""


def read(rec):
    return rec.setup_s
