"""The 95th percentile of request latency (open loops), in ms: from the
moment a request was due by the schedule to the moment its result was seen
on the host, over every request due in the window; a request that was
rejected or never answered counts as never answered."""
from ffbench.stats import percentile


def read(rec):
    if rec["loop"] != "open" or not rec["latencies_s"]:
        return None
    return percentile(rec["latencies_s"], 95) * 1e3
