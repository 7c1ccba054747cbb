"""The serve layer's median queue wait (open loops), in ms: the 50th
percentile of the server's own queue_wait samples (submit to the serving
event that dispatched the request, on the wall clock) recorded inside the
window: how long a batch takes to fill or reach its age."""
from ffbench.stats import percentile


def read(rec):
    waits = [w for w in rec["queue_waits_s"] if w is not None]
    if rec["loop"] != "open" or not waits:
        return None
    return percentile(waits, 50) * 1e3
