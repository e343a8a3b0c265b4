"""``replay_bwd_kernel``'s (B5 backward) share of its roofline over the
traced fit steps: ``roofline_replay.bwd_floor_s`` of a view times the
views replayed, over the kernel's device time."""
from portbench import roofline_replay


def read(ctx, run):
    return roofline_replay.share(ctx, run, "replay_bwd_kernel",
                                 roofline_replay.bwd_floor_s)
