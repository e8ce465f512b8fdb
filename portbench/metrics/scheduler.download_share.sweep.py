"""The sweep's drains: percent of their time spent copying the final
shared images down to the host (``download`` spans)."""
from portbench.span_parts import part_share


def read(ctx):
    return part_share(ctx, "download")
