"""frames/s: the frames whose features and matches reached the host in the
window, over the window's wall seconds (host clock)."""


def read(rec):
    w = rec["window"]
    return w["frames"] / w["seconds"] if w["seconds"] > 0 else None
