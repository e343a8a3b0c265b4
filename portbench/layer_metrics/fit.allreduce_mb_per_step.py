"""Megabytes (1e6 bytes) the program handed its all-reduce over the traced
fit steps, per step: the change of its counter
(``parallel/sharding.ALLREDUCE["bytes"]``, read by ``loops/fit_mesh``)
over those steps. None from a program that keeps no such counter, or
from an untraced run."""


def read(ctx, run):
    sent = run.get("allreduce_bytes")
    if sent is None or not run.get("items"):
        return None
    return sent / 1e6 / run["items"]
