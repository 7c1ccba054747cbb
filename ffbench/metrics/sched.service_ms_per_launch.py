"""Host time of the co-scheduler and its programs per launch (closed
loops), in ms: the server's service seconds recorded inside the window
(launch enqueue plus the gather that waits for the result) over the
window's launches."""


def read(rec):
    launches = rec["launches"]
    if rec["loop"] != "closed" or not launches:
        return None
    return rec["service_s"] / len(launches) * 1e3
