"""Per take of the window: the bytes the memory plugin copied into buffers
recycled from a deleted snapshot over all the bytes it copied into arrays
(``storage.memory.recycled_bytes`` and ``storage.memory.fresh_bytes``); the
mean over the takes. None where the program counts neither."""

from portbench.lib.readers import mean_over
from portbench.lib.recycled import share


def read(run):
    return mean_over(run, "take", share)
