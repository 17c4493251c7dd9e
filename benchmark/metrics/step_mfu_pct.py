"""Model FLOPs of the window's steps (``benchmark/flops.py``) over the
window's time × the card's peak × the cards, in %."""


def read(rec):
    win, peak = rec["window"], rec["peak_flops"]
    if not peak or not win["seconds"]:
        return None
    flops = win["steps"] * rec["flops_per_step"]
    return 100.0 * flops / (win["seconds"] * peak * rec["chips"])
