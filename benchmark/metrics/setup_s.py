"""Process start to the first timed step (host clock)."""


def read(rec):
    return rec["setup_s"]
