"""Share of the traced window in which no kernel ran on the device, %."""

from vlabench import readers


def read(run):
    return readers.idle_share(run)
