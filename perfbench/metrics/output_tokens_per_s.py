"""Every generated token of the window's requests over the window's wall
time (host clock; the window is whole chunks, each ending in the driver's
copy of its tokens to the host)."""


def read(rec):
    if rec.window_s <= 0:
        return None
    return sum(len(x.tokens) for x in rec.reqs) / rec.window_s
