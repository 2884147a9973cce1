"""wave_device_ms: the device time of every operation in the traced
window over the 2^20-lane waves it ran, in ms."""


def read(trace):
    waves = trace.counts.get("waves", 0)
    if not waves or not trace.device:
        return None
    return 1e3 * sum(e - s for _, s, e in trace.device) / waves
