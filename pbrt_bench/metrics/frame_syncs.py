"""frame_syncs: the CUDA runtime calls that wait for the device
(cudaStreamSynchronize, cudaDeviceSynchronize, cudaEventSynchronize)
inside the program's render.frame spans, per frame, from the host events
of the traced window (pbrt_bench/spans.py); no reading where the program
draws no render.frame span or the trace records no runtime call."""
from pbrt_bench import spans


def read(trace):
    return spans.syncs_per_frame(trace)
