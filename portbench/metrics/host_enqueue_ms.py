"""Host ms a step spent handing a batch in (the extractor's call, with its
upload, and the matcher's call), the benchmark's own span over every step
of the window."""


def read(rec):
    e = rec["window"]["enqueue_s"]
    return sum(e) * 1e3 / len(e) if e else None
