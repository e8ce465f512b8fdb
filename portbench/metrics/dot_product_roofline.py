"""The ``dot_product`` step kernel's share of its roofline over the
profiled drain."""
from portbench.readers import kernel_roofline


def read(ctx):
    return kernel_roofline(ctx, "dot_product")
