"""frame_gap_ms: the device's idle put down to the program's render.*
spans (models/render.py render: the frame, its setup, the film, the
finalize, and render.wave's own host time outside its graph.* spans) per
frame, in ms, over the traced window (pbrt_bench/spans.py: gaps of 20 us
or more, each split among the innermost spans over it); no reading where
the program draws no render.frame span."""
from pbrt_bench import spans


def read(trace):
    if not spans.has(trace, "render.frame"):
        return None
    return spans.per(trace, spans.idle_under(trace, "render."), "frames")
