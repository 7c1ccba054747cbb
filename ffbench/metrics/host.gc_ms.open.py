"""Host time the program's process spent in the garbage collector inside
the window (open loops), in ms: every generation's passes, timed by
gc.callbacks.  A full pass stalls the server for 0.1-0.3 s; moves
p95_ms."""


def read(rec):
    if rec["loop"] != "open" or "gc_s" not in rec:
        return None
    return rec["gc_s"] * 1e3
