"""Trained tokens of every step completed in the window over the window's
time, to the synchronise after its last step (host clock)."""


def read(rec):
    win = rec["window"]
    return win["steps"] * rec["tokens_per_step"] / win["seconds"]
