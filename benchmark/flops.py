"""What the frozen model-FLOP counts share. Each family counts its own
(``families/<family>.py``: ``train_flops_per_step``, which
``step_mfu_pct`` reads) by these rules, first set in a copy of the
port's ``flops.py`` with three changes: causal attention counts the
S(S+1)/2 query-key pairs its inputs need, not S²; a mixture of experts
counts the top-k experts' products and the router only, with no capacity
padding and no dispatch or combine products; nothing recomputed is
counted (backward = 2× forward, whatever remat runs). 2·m·n·k a product.
"""

from __future__ import annotations


def causal_pairs(seq: int) -> int:
    """Query-key pairs of causal attention over ``seq`` positions."""
    return seq * (seq + 1) // 2
