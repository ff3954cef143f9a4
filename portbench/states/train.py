"""``"state": "train"``: the trainer's model, AdamW with fp32 moments and
a step counter, trained by the window's steps."""

from portbench.lib.state import TrainState


def build(cfg, traffic, seed, device):
    return TrainState(cfg, traffic, seed, device)
