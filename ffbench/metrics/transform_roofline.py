"""The transform's share of its roofline in the traced window, in %: the
least time of the window's launches (ffbench/work.py: the paper's
matrix-form count, at the card's published peaks, 700 W) over the device
time of the launches' programs: every device operation in the window but
the copies between host and device (ffbench/devtrace.py), so every kernel a
program runs counts, whatever its name.

The count assumes the matrix form with byte limbs; a program that computes
the transform by another method (butterflies, say) needs a benchmark change
to recount it."""


def read(rec):
    t = rec.get("trace")
    if t is None or rec["loop"] != "closed":
        return None
    if t["program_s"] <= 0 or t["least_s"] <= 0:
        return None
    return 100.0 * t["least_s"] / t["program_s"]
