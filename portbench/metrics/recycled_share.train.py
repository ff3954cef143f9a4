"""Per async take that committed in the window: the bytes its drain copied
into the memory plugin's buffers recycled from a deleted snapshot over all
the bytes it copied into arrays (``storage.memory.recycled_bytes`` and
``storage.memory.fresh_bytes``); the mean over those takes. None where the
program counts neither."""

from portbench.lib.readers import committed_in_window, mean
from portbench.lib.recycled import share


def read(run):
    return mean(v for v in map(share, committed_in_window(run)) if v is not None)
