"""Rank 0's device time in the NCCL all-reduce kernels (operations whose
name holds ``AllReduce``) over the traced fit steps, per step: the
exchange of the loss and gradients that ``fit(mesh=)`` makes once a step.
A rank's all-reduce kernel starts when that rank reaches the exchange and
ends when every rank has, so the time includes the wait for the slowest
rank as well as the transfer over NVLink. None where the trace holds no
such kernel: a run on one card, on the CPU (gloo), or an untraced run."""
from portbench import tracing


def read(ctx, run):
    tr = run.get("trace") or {}
    t = tracing.kernel_seconds(tr, "AllReduce")
    if t <= 0.0 or not tr.get("spans"):
        return None
    return 1e3 * t / tr["spans"]
