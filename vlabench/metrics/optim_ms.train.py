"""Span of the optimizer's update (``Optimizer.step_``: the clip and every
parameter's AdamW), from the device idle before it to its last kernel's
end, ms, mean over the window's steps."""

from vlabench import readers


def read(run):
    return readers.optim_ms(run)
