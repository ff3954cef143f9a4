"""As ``idle_gil_share.train``, but counting only the idle seconds that
lie under both a ``host.gil_wait`` span and a ``scheduler.io`` or
``storage.write`` span: the memory plugin's copies (a streamed object's
appends and commit, a whole object's write) held the lock, or were in
flight while it was held."""

from portbench.lib import cells


def read(run):
    return cells.reader("idle_gil_share.train").idle_share(run, ("scheduler.io", "storage.write"))
