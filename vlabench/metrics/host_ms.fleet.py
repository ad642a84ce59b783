"""Host time of a served request: its latency at the client minus the span
of the policy call that answered it (HTTP, the micro-batcher's wait, frame
decode and preprocess, tokenisation, the reply), ms, mean over the
requests answered in the window."""

from vlabench import readers


def read(run):
    return readers.host_ms(run)
