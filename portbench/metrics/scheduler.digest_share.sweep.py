"""The sweep's drains: percent of their time spent digesting the
batches' inputs into their residency keys (``digest`` spans)."""
from portbench.span_parts import part_share


def read(ctx):
    return part_share(ctx, "digest")
