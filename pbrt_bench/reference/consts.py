"""Shape and light kind ids of the plain reference, the program's own
numbering (jet_pbrt_tpu_torch/scene/pack.py at commit 77f45ea)."""

KIND_TRI = 0
KIND_SPHERE = 1
KIND_RECT = 2
KIND_DISK = 3
KIND_INST = 4  # instanced mesh family mi has kind KIND_INST + mi

LIGHT_POINT = 0
LIGHT_DIRECTIONAL = 1
LIGHT_AREA = 2
LIGHT_ENV = 3
