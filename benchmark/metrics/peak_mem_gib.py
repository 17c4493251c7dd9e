"""The allocator's peak over set-up and window, in GiB."""


def read(rec):
    return rec["memory_peak_bytes"] / 2**30
