"""Host time in the server's ``submit`` and ``tick`` and in reading each
answer, over the window, per request answered (host clock)."""


def read(rec):
    return rec.host_request_s / rec.completed * 1e3 if rec.completed else None
