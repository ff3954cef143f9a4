"""Seconds from the process's start to the window's: imports, building or
loading the kernels, making the state, warming up."""


def read(run):
    return run.setup.get("setup_s")
