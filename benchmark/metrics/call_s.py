"""call_s: the window's seconds over the calls in it."""


def read(rec):
    return rec["window_s"] / len(rec["calls"])
