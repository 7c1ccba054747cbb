"""Live rows per launch over the window's launches (closed loops), from the
server's dispatch records."""


def read(rec):
    launches = rec["launches"]
    if rec["loop"] != "closed" or not launches:
        return None
    return sum(live for _, live, _ in launches) / len(launches)
