"""Percent of the device ops' time in the sweep's profiled drain spent
in kernels other than the port's hand kernels: the torch-op rows
(copies and fills are ``device.copy_share.sweep``'s)."""
from portbench.readers import torch_op_share


def read(ctx):
    return torch_op_share(ctx)
