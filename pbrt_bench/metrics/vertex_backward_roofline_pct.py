"""vertex_backward_roofline_pct: 100 x the transpose of the step's path
vertices' bytes bound (pbrt_bench/yardstick.py: vertex_backward_bytes and
grad_reduce_bytes of each vertex, the frozen counts, at the card's HBM
peak) / the device time of vertex_backward_kernel and grad_reduce_kernel,
per step."""
from pbrt_bench import yardstick as y


def read(trace):
    t = trace.kernel_s("vertex_backward_kernel", "grad_reduce_kernel")
    steps = trace.counts.get("steps", 0)
    if not t or not steps:
        return None
    f = trace.facts
    n, slots = f["lanes"], f["slots"]
    per = lambda last: (y.vertex_backward_bytes(
        n, f["n_lights"], f["nee_lights"], slots, last)
        + y.grad_reduce_bytes(n, slots))
    nbytes = f["depth"] * per(False) + per(True)
    return 100.0 * y.bytes_ms(nbytes) / (1e3 * t / steps)
