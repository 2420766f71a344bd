"""Requests a drain of the server's: ``TickReport.resolved`` over
``TickReport.drains``, summed over the window's ticks (a tick of one
request drains it unstacked, and counts as a drain of one)."""


def read(rec):
    return rec.resolved / rec.drains if rec.drains else None
