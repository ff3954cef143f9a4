"""Toy sizes of the benchmark's cells for the CPU tests: the cells'
configurations and traffic with widths, depth and the checkpoint interval
cut down, run through ``harness.run_cell(device="cpu")``."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench.lib import cells  # noqa: E402

TOY = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4, ffn_dim=64, vocab_size=128, max_position_embeddings=16)
CELLS = [w["name"] for w in cells.load_benchmark()["workloads"]]


def toy_cell(name):
    """(configuration, traffic) of cell ``name`` at toy size."""
    w = cells.workload(cells.load_benchmark(), name)
    cfg = dict(cells.config(w["config"]), **TOY)
    traffic = dict(cells.traffic(w["traffic"]))
    if traffic.get("every_steps"):
        traffic["every_steps"] = 3
    return cfg, traffic
