"""vertex_roofline_pct: 100 x the path vertex's bytes bound / the device
time of shade_vertex_kernel, per wave. The bound is the vertex's inputs
read once and outputs written once (pbrt_bench/yardstick.py::vertex_bytes,
the frozen count) at the card's HBM peak, for depth vertices with NEE and
the last one, over the wave's lanes: the same work whatever computes the
vertex."""
from pbrt_bench import yardstick as y


def read(trace):
    t = trace.kernel_s("shade_vertex_kernel")
    waves = trace.counts.get("waves", 0)
    if not t or not waves:
        return None
    f = trace.facts
    args = (f["lanes"], f["n_lights"], f["nee_lights"], f["tables"])
    nbytes = (f["depth"] * y.vertex_bytes(*args, last=False)
              + y.vertex_bytes(*args, last=True))
    return 100.0 * y.bytes_ms(nbytes) / (1e3 * t / waves)
