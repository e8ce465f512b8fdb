"""Percent of the service's profiled slice in which the device ran
nothing."""
from portbench.readers import idle


def read(ctx):
    return idle(ctx)
