"""From the harness's first line to the first timed drain: imports, the
kernels loaded (built on a checkout's first run), the weights made on the
device, the engine and its pool, and the warm-up."""


def read(rec):
    return rec.setup_s
