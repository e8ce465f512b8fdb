"""The service's drains: percent of their time spent on the host outside
dispatch and device sync (partition, buckets, residency, collect)."""
from portbench.readers import host_share


def read(ctx):
    return host_share(ctx)
