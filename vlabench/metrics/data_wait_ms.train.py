"""Seconds a training step waited on its batch (the trainer's own
``data_wait_s`` in ``metrics.jsonl``), ms, mean over the window's steps."""

from vlabench import readers


def read(run):
    return readers.data_wait_ms(run)
