"""Model FLOPs of the window's training steps over the window's seconds, as
a percentage of the card's bf16 peak (989 TFLOP/s): ``6 N + 12 L d s`` a
token (``lib/arith.py``)."""

from portbench.lib import arith


def read(run):
    steps = run.in_window("step")
    if not steps:
        return None
    flops = len(steps) * run.numbers["tokens_per_step"] * run.numbers["flops_per_token"]
    return arith.mfu_pct(flops, run.window_s)
