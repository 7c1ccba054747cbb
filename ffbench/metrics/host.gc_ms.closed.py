"""Host time the program's process spent in the garbage collector inside
the window (closed loops), in ms: every generation's passes, timed by
gc.callbacks.  A full pass stalls the server for 0.1-0.3 s; moves
ops_per_s."""


def read(rec):
    if rec["loop"] != "closed" or "gc_s" not in rec:
        return None
    return rec["gc_s"] * 1e3
