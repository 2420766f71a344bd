"""Host time from the entry's call to its return, before the client waits
for the card, averaged over the window's calls (host clock)."""


def read(rec):
    return sum(rec.entry_host_s) / len(rec.entry_host_s) * 1e3 if rec.entry_host_s else None
