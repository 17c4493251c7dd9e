"""Device ms a step in the latent attention's own work: the kv
down-projection and its split, the latent norm's call, the up-projection,
the shared rope key's broadcast and the q/k assembly
(``workload.latent``), self time with the backward halves (the norm's
kernels stay in ``norm``, RoPE in ``rope``, the casts in ``cast``), from
the port's span table of the traced capture (``progspans.py``)."""

from benchmark import progspans

SPANS = ("latent",)


def read(rec):
    return progspans.ms_per_step((rec["trace"] or {}).get("program"), SPANS)
