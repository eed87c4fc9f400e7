"""The most device memory allocated during the window, GiB
(torch.cuda.max_memory_allocated, reset at the window's start)."""


def read(rec):
    m = rec.get("memory")
    return m["window_peak_bytes"] / 2 ** 30 if m else None
