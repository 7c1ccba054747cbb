"""Process start to the first timed request: imports, the CUDA context, the
kernel library, the server and its engines, and the warm-up of the cell's
own traffic (every capture and validator probe)."""


def read(rec):
    return rec["setup_s"]
