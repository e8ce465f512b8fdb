"""The sweep's drains: percent of their time spent packing the batches'
inputs into zeroed host images (``pack`` spans)."""
from portbench.span_parts import part_share


def read(ctx):
    return part_share(ctx, "pack")
