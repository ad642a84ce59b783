"""K2's share of its roofline: the least time of the guided DDIM sampling
calls (``fused_dit_sample``: every step's DiT over 2 B rows of T + 1
tokens, the weights read once) over the device time of the kernels
launched inside them, %."""

from vlabench import readers


def read(run):
    return readers.k2_roofline(run)
