"""Percent of the bytes the sweep copied up that its jobs carry: the
``upload`` spans' ``payload_bytes`` over their ``bytes`` (the rest of
each lane's shared image is zeros)."""
from portbench.span_parts import payload_share


def read(ctx):
    return payload_share(ctx)
