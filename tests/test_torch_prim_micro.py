"""The port's wide-kernel primitives harness
(jet_pbrt_tpu_torch/scripts/prim_micro.py) against the reference harness
scripts/prim_micro.py.

The reference's eleven kernels run through its own `main` and `run` in
Pallas interpret mode on the CPU (`pl.pallas_call` given interpret=True) at
REPS = 16; `run`'s `jax.jit` is replaced by one that evaluates the kernel
once and keeps its output, in place of the timing. Each probe's plain
version must equal that output bit for bit (mt is inf everywhere) at the
same REPS, and the port's tables must equal the ones the reference drew,
bit for bit. No tolerance: both sides round every operation alike,
including the update acc + s * 1e-9, which XLA fuses into one multiply-add.
"""
import functools
import importlib.util
import os
import re
import sys
import types

import numpy as np
import jax
import pytest
import torch
from jax.experimental import pallas as pl

from jet_pbrt_tpu_torch.scripts import prim_micro as P

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPS = 16


@pytest.fixture(scope="module")
def ref():
    """scripts/prim_micro.py, loaded by path (scripts/ is not a package)."""
    spec = importlib.util.spec_from_file_location(
        "reference_prim_micro", os.path.join(ROOT, "scripts", "prim_micro.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_reference(ref, monkeypatch, argv):
    """Run the reference's main with `argv` in interpret mode; returns
    {probe: (out [8, 8, 128], tables)} as numpy arrays."""
    monkeypatch.setattr(ref, "REPS", REPS)
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    captured = {}
    run = ref.run

    def capturing_run(name, kern, tables):
        def jit(fn):
            def once(*ts):
                if name not in captured:
                    captured[name] = (np.asarray(fn(*ts)),
                                      [np.asarray(t) for t in ts])
                return captured[name][0]
            return once
        monkeypatch.setattr(ref, "jax", types.SimpleNamespace(
            jit=jit, block_until_ready=lambda r: r,
            ShapeDtypeStruct=jax.ShapeDtypeStruct))
        run(name, kern, tables)

    monkeypatch.setattr(ref, "run", capturing_run)
    monkeypatch.setattr(sys, "argv", ["prim_micro.py", *argv])
    ref.main()
    return captured


def _bits(x: torch.Tensor) -> np.ndarray:
    return x.view(torch.int16 if x.dtype == torch.bfloat16
                  else torch.int32).numpy()


@pytest.mark.parametrize("probe", P.PROBES)
def test_plain_matches_reference_kernel(ref, monkeypatch, probe):
    out, tables = _run_reference(ref, monkeypatch, [probe])[probe]
    table = P.tables("cpu")[P.TABLE_OF[probe]]
    np.testing.assert_array_equal(
        _bits(table), tables[0].view(_bits(table).dtype))
    before = P.prim_micro.launches
    got = P.prim_micro(probe, table, REPS)
    assert P.prim_micro.launches == before  # CPU: the plain version
    assert got.shape == (P.GRID, P.ROWS, P.LANES) == out.shape
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  out.view(np.uint32))
    assert np.isinf(out).all() if probe == "mt" else np.isfinite(out).all()


def test_main_on_cpu_prints_the_reference_lines(ref, monkeypatch, capsys):
    """Defaults and the per-probe line format are the reference's; the CPU
    runs the plain versions and launches nothing."""
    names = []
    monkeypatch.setattr(ref, "run", lambda name, kern, tables:
                        names.append(name))
    monkeypatch.setattr(sys, "argv", ["prim_micro.py"])
    ref.main()
    assert tuple(names) == P.DEFAULT

    monkeypatch.setattr(P, "REPS", REPS)
    before = P.prim_micro.launches
    ns, outs = P.main(device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("# CPU, plain: ns per dependent iteration")
    assert lines[1:] == [f"{p}: {ns[p]:8.1f} ns/iter" for p in P.DEFAULT]
    assert all(re.fullmatch(r"\w+: +\d+\.\d ns/iter", ln) for ln in lines[1:])
    assert P.prim_micro.launches == before
    # the outputs of the timed runs are the probes' values at REPS
    for p in P.DEFAULT:
        assert torch.equal(outs[p], P.prim_micro_plain(
            p, P.tables("cpu")[P.TABLE_OF[p]], REPS)), p
    with pytest.raises(ValueError, match="unknown probes"):
        P.main(["m9"], device="cpu")


def test_wrapper_checks_its_arguments():
    tabs = P.tables("cpu")
    with pytest.raises(ValueError, match="unknown probe"):
        P.prim_micro("m9", tabs["tb_bf16"], 4)
    with pytest.raises(ValueError, match="table"):
        P.prim_micro("f1", tabs["tb_bf16"], 4)
    with pytest.raises(ValueError, match="table"):
        P.prim_micro("m1", tabs["tb_bf16"].float(), 4)
    with pytest.raises(ValueError, match="table"):
        P.prim_micro("m1", tabs["tb_bf16"].t(), 4)
    with pytest.raises(ValueError, match="reps"):
        P.prim_micro("m1", tabs["tb_bf16"], -1)
