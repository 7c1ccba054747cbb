"""Served requests whose rows came back inside the window, over the
window's wall time (closed loops)."""


def read(rec):
    if rec["loop"] != "closed":
        return None
    return rec["served_in_window"] / rec["seconds"]
