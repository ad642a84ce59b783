"""K1's share of its roofline in training: the visible query-key pairs and
bytes of every attention call of the decoder and the expert (forward and
its recomputation under checkpointing) over the device time of the kernels
launched inside them, %."""

from vlabench import readers


def read(run):
    return readers.k1_roofline(run)
