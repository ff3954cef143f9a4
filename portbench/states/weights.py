"""``"state": "weights"``: the model's parameters alone, as a serving
replica holds them; nothing trains."""

from portbench.lib.state import ModelState


def build(cfg, traffic, seed, device):
    state = ModelState(cfg, traffic, seed, device)
    state.model.requires_grad_(False)
    return state
