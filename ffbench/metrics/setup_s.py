"""Process start to the end of the server's warm-up: imports, the CUDA
context, the kernel library, the server and its engines, and the warm-up of
the cell's own traffic (every capture and validator probe) until the device
has finished it.  Not the window's requests drawn by the load generator nor
the heap collected after them (``notes.setup_parts_s``)."""


def read(rec):
    return rec["setup_s"]
