"""replay_gap_ms.offline: the device's idle put down to the program's
graph.* spans (models/graph.py: the wave's key, the copies into its
graph's buffers, the replay's launch, its launch count) per wave, in ms,
over the offline cells' traced window (pbrt_bench/spans.py: gaps of 20 us
or more, each split among the innermost spans over it); no reading where
the program draws no graph.* span."""
from pbrt_bench import spans


def read(trace):
    return spans.per(trace, spans.idle_under(trace, "graph."), "waves")
