"""brute_ms_per_wave: the device time of brute_hits_kernel over the waves
run, in ms; no reading where no cast takes it."""


def read(trace):
    t = trace.kernel_s("brute_hits_kernel")
    waves = trace.counts.get("waves", 0)
    if not t or not waves:
        return None
    return 1e3 * t / waves
