"""The device's idle share of the window: 100 x (1 - the union of its
kernels, memcpys and memsets over the window's seconds)."""

from portbench.lib.readers import device_idle_pct


def read(run):
    return device_idle_pct(run)
