"""K3's share of its roofline: the visible query-key pairs and bytes of
every flash backward (``flash_attention_bwd``, the entry of
``FlashAttention``'s backward) over the device time of the kernels
launched inside them, %."""

from vlabench import readers


def read(run):
    return readers.k3_roofline(run)
