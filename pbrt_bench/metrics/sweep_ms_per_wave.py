"""sweep_ms_per_wave: the device time of the cull-sweep kernel
(sweep_bvh_kernel) over the waves run, in ms; no reading where the cell's
scene sends no cast through it."""


def read(trace):
    t = trace.kernel_s("sweep_bvh_kernel")
    waves = trace.counts.get("waves", 0)
    if not t or not waves:
        return None
    return 1e3 * t / waves
