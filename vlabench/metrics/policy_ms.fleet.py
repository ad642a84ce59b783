"""Span of the server's policy call (``cogact_inference_action`` as the
server calls it) up to its result on the host, ms, mean over the calls that
started in the window."""

from vlabench import readers


def read(run):
    return readers.policy_ms(run)
