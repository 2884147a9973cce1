"""replay_host_ms: the host self time of the program's graph.* spans
(models/graph.py: each span's length minus what the spans inside it
cover) per wave, in ms, over the traced window (pbrt_bench/spans.py); no
reading where the program draws no graph.* span. Read where a wave's host
work is exposed (the Cornell box's cheap waves): where the host runs
ahead, graph.launch holds cudaGraphLaunch waiting for room in the card's
queue, and the reading follows the device's wave time instead."""
from pbrt_bench import spans


def read(trace):
    return spans.per(trace, spans.self_seconds(trace, "graph."), "waves")
