"""Model FLOPs of the chunks answered in the traced window (tower, projector,
decoder over each request's valid tokens, the guided samples) over the
window's seconds times the bf16 peak, %."""

from vlabench import readers


def read(run):
    return readers.serve_mfu(run)
