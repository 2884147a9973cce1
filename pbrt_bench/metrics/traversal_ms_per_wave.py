"""traversal_ms_per_wave: the device time of the wide BVH kernel's two
passes (wide_cull_kernel, wide_walk_kernel) over the waves run, in ms; no
reading where the cell's scene sends no cast through them."""


def read(trace):
    t = trace.kernel_s("wide_cull_kernel", "wide_walk_kernel")
    waves = trace.counts.get("waves", 0)
    if not t or not waves:
        return None
    return 1e3 * t / waves
