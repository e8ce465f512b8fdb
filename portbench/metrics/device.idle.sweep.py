"""Percent of the sweep's profiled drain in which the device ran
nothing."""
from portbench.readers import idle


def read(ctx):
    return idle(ctx)
