"""frame_host_ms: the host time of each render() call outside its
render.wave ranges (the frame's setup, camera, film and finalize), as a
mean over the traced frames, from the benchmark's bench.render span and
the program's render.wave ranges."""


def read(trace):
    renders = trace.ranges("bench.render")
    waves = trace.ranges("render.wave")
    if not renders or not waves:
        return None
    host = []
    for s, e in renders:
        inner = sum(min(b, e) - max(a, s) for a, b in waves
                    if b > s and a < e)
        host.append(e - s - inner)
    return 1e3 * sum(host) / len(host)
