"""The device's idle share of the traced window (closed loops), in %:
1 - (union of every kernel and copy interval) / (window length)."""


def read(rec):
    t = rec.get("trace")
    if (t is None or rec["loop"] != "closed" or t["window_s"] <= 0
            or t["busy_s"] <= 0):
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
