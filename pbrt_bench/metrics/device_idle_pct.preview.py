"""device_idle_pct.preview: 100 x (1 - the union of the device's operation
intervals / the traced window), from the torch.profiler trace of the
preview cells' window."""


def read(trace):
    return trace.idle_pct()
