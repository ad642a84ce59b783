"""Model FLOPs of the samples of the steps in the traced window (forward and
backward of the tower, projector, VLM, expert and joint attention over
valid tokens, remat not counted) over the window's seconds times the bf16
peak, %."""

from vlabench import readers


def read(run):
    return readers.train_mfu(run)
