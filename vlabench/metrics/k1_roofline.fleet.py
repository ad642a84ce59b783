"""K1's share of its roofline: the least time of the visible query-key pairs
and the bytes of every decoder attention call (the port's ``attention``
entry) over the device time of the kernels launched inside those calls, %."""

from vlabench import readers


def read(run):
    return readers.k1_roofline(run)
