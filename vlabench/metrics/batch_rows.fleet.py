"""Frames a policy call served (the micro-batcher's batch, padding not
counted), over all calls that started in the window."""

from vlabench import readers


def read(run):
    return readers.batch_rows(run)
