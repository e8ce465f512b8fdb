"""The sweep's drains: percent of their time spent copying the packed
inputs up to the device (``upload`` spans)."""
from portbench.span_parts import part_share


def read(ctx):
    return part_share(ctx, "upload")
