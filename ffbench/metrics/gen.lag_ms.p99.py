"""How late the load generator submitted (open loops), in ms: the 99th
percentile over the window's requests of submit time minus due time, on
the generator's own clock.  Moves p95_ms: a lagging generator is a host
that cannot keep to the schedule."""
from ffbench.stats import percentile


def read(rec):
    if rec["loop"] != "open" or not rec["lags_s"]:
        return None
    return percentile(rec["lags_s"], 99) * 1e3
