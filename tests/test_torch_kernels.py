"""The kernel binding (jet_pbrt_tpu_torch/ops/kernels.py) on the CPU.

The route rule for every registered wrapper: a call on `meta`-device
tensors, a device that is neither the CPU nor the card, raises `no <name>
route` rather than take the plain version or reach a kernel (each
wrapper's own input checks run first where it has them, so its inputs are
of the shapes those checks take). Then a library's declaration against a
stand-in of its C functions (a layout that differs raises) and the
substitution of another build. The launch itself runs only on the card
(tests/test_torch_cuda.py). JAX-free.
"""
import collections
import ctypes
from types import SimpleNamespace

import pytest
import torch

from jet_pbrt_tpu_torch.ops import brute as TB
from jet_pbrt_tpu_torch.ops import intersect as tis
from jet_pbrt_tpu_torch.ops import kernels
from jet_pbrt_tpu_torch.ops import rays as TRAY
from jet_pbrt_tpu_torch.ops import rng as TR
from jet_pbrt_tpu_torch.ops import shade as TSH
from jet_pbrt_tpu_torch.ops import sweep_bvh as TS
from jet_pbrt_tpu_torch.ops import wave as TWAVE
from jet_pbrt_tpu_torch.ops import wide_bvh as TW
from jet_pbrt_tpu_torch.scripts import prim_micro, sweep_prims

N = 4


def _m(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype, device="meta")


def _wave_state():
    return TWAVE.WaveState(
        L=_m(N, 3), beta=_m(N, 3), active=_m(N, dtype=torch.bool),
        prev_specular=_m(N, dtype=torch.bool), prev_pdf=_m(N),
        ray_o=_m(N, 3), ray_d=_m(N, 3), lane=_m(N, dtype=torch.int64),
        tmin=_m(N), tmax=_m(N), counts=_m(4, dtype=torch.int64))


def _wide_call():
    leaf = 4
    tables = TW.WideTables(
        bounds=_m(1, TW.WIDTH, 6), child=_m(1, TW.WIDTH, dtype=torch.int32),
        tris=_m(leaf, 9), inst=_m(1, 4), blas_root=0, depth=1,
        planar=_m(1, 6, TW.WIDTH))
    return TW.intersect_wide(tables, _m(N, 3), _m(N, 3), _m(N), _m(N),
                             any_hit=False, has_inst=False, leaf_size=leaf,
                             n_tris=leaf)


def _sweep_call():
    tables = TS.SweepTables(
        sph=_m(8, TS.RAYS), mt=_m(9, TS.GROUP), inst=_m(4), root=_m(8),
        n_groups=1, n_inst=0, sup=_m(8, TS.RAYS // TS.SUPER))
    return TS.intersect_sweep(tables, _m(N, 3), _m(N, 3), _m(N), _m(N),
                              any_hit=False, n_tris=TS.GROUP)


def _vertex_state():
    s = _wave_state()
    return TSH.VertexState(*s[:7])


PACK = SimpleNamespace(ray_eps=_m(), world_center=_m(3), world_radius=_m())
KEYS = TR.LaneKeys(_m(N, dtype=torch.int32), _m(N, dtype=torch.int32),
                   _m(N, dtype=torch.int64))
# wrapper name -> a call of it on meta tensors
CALLS = {
    "shadow_key": lambda: TRAY.shadow_key(None, PACK, _m(N, 3), _m(N, 3)),
    "shadow_segments": lambda: TRAY.shadow_segments(PACK, _m(N, 3),
                                                    _m(N, 3)),
    "occlusion_merge": lambda: TRAY.occlusion_merge(
        [_m(N, dtype=torch.bool)]),
    "hit_reconstruct": lambda: TRAY.hit_reconstruct(
        _m(N, 3), _m(N, 3), [tis.KindHit(_m(N), _m(N, dtype=torch.int32),
                                         _m(N, dtype=torch.bool))],
        [TRAY.KIND_SPHERE], {}, [], False),
    "camera_rays": lambda: TWAVE.camera_rays(
        collections.namedtuple("Cam", "position")(_m(3)),
        _m(N, dtype=torch.int64), 2, _m(N, 2), _m()),
    "permute_state": lambda: TWAVE.permute_state(
        _wave_state(), KEYS, _m(N, dtype=torch.int64)),
    "unsort_guard": lambda: TWAVE.unsort_guard(_m(N, 3)),
    "permute_state_backward": lambda: TWAVE.permute_state_backward(
        _m(N, dtype=torch.int64), _m(N, 3), None),
    "unsort_guard_backward": lambda: TWAVE.unsort_guard_backward(
        _m(N, 3), None, _m(N, 3)),
    "brute_hits": lambda: TB.brute_hits(
        _m(N, 3), _m(N, 3), _m(N), _m(N),
        tis.BruteShapes(tri=(_m(1, 3), _m(1, 3), _m(1, 3)), sph=None,
                        rect=None, disk=None), False),
    "lane_keys": lambda: TR.lane_keys(0, 0, _m(N, dtype=torch.int64)),
    "uniforms": lambda: TR.uniforms(KEYS, TR.PURPOSE_CAMERA, 2),
    "shade_vertex": lambda: TSH.shade_vertex(None, None, None,
                                             _vertex_state(), None, 0, 1),
    "nee_accumulate": lambda: TSH.nee_accumulate(
        _m(N, 3), _m(1, N, dtype=torch.bool), _m(1, N, dtype=torch.bool),
        _m(1, N, 3)),
    "vertex_backward": lambda: TSH.vertex_backward(
        None, None, None, _vertex_state(), None, 0, 1, None, None,
        _m(N, 3)),
    "grad_reduce": lambda: TSH.grad_reduce(_m(2, 5)),
    "intersect_wide": _wide_call,
    "intersect_sweep": _sweep_call,
    "prim_micro": lambda: prim_micro.prim_micro(
        "m1", prim_micro.tables("cpu")["tb_bf16"].to("meta"), 4),
    "sweep_prims": lambda: sweep_prims.sweep_prims(
        _m(sweep_prims.K, sweep_prims.L), _m(sweep_prims.K, sweep_prims.L)),
}


@pytest.mark.parametrize("kernel", sorted(kernels.REGISTRY))
def test_every_wrapper_refuses_a_device_without_a_route(kernel):
    """Each registered wrapper on `meta` tensors raises `no <name> route`:
    the plain version is for CPU tensors alone, the kernel for CUDA
    ones."""
    _, name = kernels.REGISTRY[kernel]
    before = kernels.counts()
    with pytest.raises(ValueError, match=f"no {name} route for device meta"):
        CALLS[name]()
    assert kernels.counts() == before


class _Fn:
    """A stand-in of a ctypes function: takes the types declare sets and
    returns `value`."""

    def __init__(self, value=0):
        self.value = value

    def __call__(self, *args):
        return self.value


def _stand_in(size):
    return SimpleNamespace(launch=_Fn(), args_size=_Fn(size),
                           table_width=_Fn(32))


class _Args(ctypes.Structure):
    _fields_ = [("n", ctypes.c_int), ("x", ctypes.c_void_p)]


@pytest.mark.parametrize("size,ok", [(ctypes.sizeof(_Args), True),
                                     (ctypes.sizeof(_Args) + 8, False)])
def test_library_declares_and_holds_its_layouts(size, ok):
    """declare sets every function's argument and return types and holds
    each layout export against its Structure or width: a build whose
    layout differs from the wrapper's raises."""
    lib = kernels.Library("a_stand_in", ["none.cu"],
                          {"launch": [kernels.PTR, kernels.INT]},
                          {"args_size": _Args, "table_width": 32})
    kernels.LIBRARIES.pop("a_stand_in")
    built = _stand_in(size)
    if ok:
        lib.declare(built)
        assert built.launch.argtypes == [kernels.PTR, kernels.INT]
        assert built.launch.restype is ctypes.c_int
        assert built.args_size.argtypes == []
    else:
        with pytest.raises(RuntimeError, match="disagree on _Args"):
            lib.declare(built)


def test_substitute_puts_another_build_in_place():
    """While substitute is open the library's wrappers load the other
    build; after it, their own again (also when the block raises)."""
    lib = kernels.LIBRARIES["threefry"]
    other = _stand_in(0)
    with kernels.substitute(lib, other):
        assert lib.load() is other
        with pytest.raises(KeyError):
            with kernels.substitute(lib, _stand_in(1)):
                raise KeyError("a failed turn")
        assert lib.load() is other
    assert lib._in_place is None


def test_copy_out_writes_the_plain_outputs_into_out():
    got = tis.KindHit(torch.ones(3), torch.full((3,), 2, dtype=torch.int32),
                      torch.ones(3, dtype=torch.bool))
    out = tis.KindHit(torch.zeros(3), torch.zeros(3, dtype=torch.int32),
                      torch.zeros(3, dtype=torch.bool))
    assert kernels.copy_out(got, None) is got
    written = kernels.copy_out(got, out)
    assert isinstance(written, tis.KindHit)
    assert all(w is o and torch.equal(w, g)
               for w, o, g in zip(written, out, got))
    flag = torch.zeros(3, dtype=torch.bool)
    assert kernels.copy_out(got.valid, flag) is flag and bool(flag.all())
