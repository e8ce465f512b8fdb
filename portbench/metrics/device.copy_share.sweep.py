"""Percent of the device ops' time in the sweep's profiled drain spent
in copies and fills: the inputs' copy up and the results' copy down."""
from portbench.readers import copy_share


def read(ctx):
    return copy_share(ctx)
