"""The port's image files and command line against the JAX package's: the
BMP, PPM and HDR writers produce the reference writers' bytes for the same
image and `read_ppm` inverts them the same way; `python -m
jet_pbrt_tpu_torch.cli` writes a file whose header equals the reference
CLI's and whose pixel bytes are within 1 of it; and it renders on the card
unless asked for the CPU.

The reference CLI runs op by op here (jax.disable_jit): under jit XLA
contracts a * b + c into fused multiply-adds, which moves a few paths of
an 8^2 frame (see tests/test_torch_render.py).
"""
import os

import numpy as np
import jax
import pytest
import torch

from jet_pbrt_tpu import cli as jcli
from jet_pbrt_tpu.utils import image as jimage
from jet_pbrt_tpu_torch import cli as tcli
from jet_pbrt_tpu_torch.models import film as tfilm
from jet_pbrt_tpu_torch.utils import image as timage

torch.set_num_threads(2)

HEADER = {"bmp": 54, "hdr": None, "ppm": None}


def _image(seed=0, h=13, w=10):
    """An HDR image with zeros, values above 1 and tiny values."""
    rs = np.random.default_rng(seed)
    img = rs.exponential(0.4, (h, w, 3)).astype(np.float32)
    img[0, 0] = 0.0
    img[1, 1] = (1e-33, 2.0, 7.5)
    img[2, :3] = 1.0
    return img


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("fmt", ["bmp", "ppm", "hdr"])
@pytest.mark.parametrize("width", [10, 11])
def test_writers_byte_identical(tmp_path, fmt, width):
    """Odd widths exercise the BMP's row padding; the HDR takes the image
    unclamped (RGBE via frexp)."""
    img = _image(width, w=width)
    a = jimage.save_image(str(tmp_path / "ref"), img, fmt)
    b = timage.save_image(str(tmp_path / "port"), img, fmt)
    assert b.endswith("." + fmt)
    assert _read(a) == _read(b)
    # film.save takes a tensor and writes the same file
    c = tfilm.save(torch.from_numpy(img), str(tmp_path / "film"), fmt)
    assert _read(c) == _read(a)


def test_read_ppm_inverts_like_reference(tmp_path):
    img = _image(3)
    path = str(tmp_path / "x.ppm")
    timage.write_ppm(path, img)
    np.testing.assert_array_equal(timage.read_ppm(path),
                                  jimage.read_ppm(path))
    np.testing.assert_array_equal(timage.gamma_encode(img),
                                  jimage.gamma_encode(img))
    with pytest.raises(ValueError, match="unknown image format"):
        timage.save_image(str(tmp_path / "x"), img, "png")


def _split(data: bytes, fmt: str):
    """(header, pixel bytes) of a written file."""
    if fmt == "bmp":
        return data[:54], np.frombuffer(data[54:], np.uint8)
    if fmt == "hdr":
        head = data.index(b"+X")
        head = data.index(b"\n", head) + 1
        return data[:head], np.frombuffer(data[head:], np.uint8)
    lines = data.split(b"\n", 3)
    return b"\n".join(lines[:3]), np.array(lines[3].split(), np.int64)


@pytest.mark.parametrize("fmt", ["bmp", "ppm"])
def test_cli_matches_reference_cli(tmp_path, fmt):
    args = ["0", "2", "--size", "8", "--max-depth", "3", "--format", fmt,
            "--seed", "3"]
    with jax.disable_jit():
        assert jcli.main(args + ["--platform", "cpu", "--out",
                                 str(tmp_path / "ref")]) == 0
    assert tcli.main(args + ["--device", "cpu", "--out",
                             str(tmp_path / "port")]) == 0
    ha, pa = _split(_read(str(tmp_path / f"ref.{fmt}")), fmt)
    hb, pb = _split(_read(str(tmp_path / f"port.{fmt}")), fmt)
    assert ha == hb
    assert pa.shape == pb.shape
    diff = np.abs(pa.astype(np.int64) - pb.astype(np.int64))
    assert diff.max() <= 1, int(diff.max())


@pytest.mark.parametrize("flags", [["--integrator", "debug"],
                                   ["--integrator", "whitted", "--mis"],
                                   ["--sampler", "stratified", "--format",
                                    "hdr", "--no-clamp"]])
def test_cli_options_write_files(tmp_path, flags):
    out = str(tmp_path / "img")
    assert tcli.main(["0", "1", "--size", "6", "--max-depth", "2",
                      "--device", "cpu", "--out", out] + flags) == 0
    fmt = "hdr" if "hdr" in flags else "bmp"
    assert os.path.getsize(f"{out}.{fmt}") > 0


def test_cli_rejects_bad_arguments():
    assert tcli.main(["7", "1", "--device", "cpu"]) == 1
    assert tcli.main(["0", "0", "--device", "cpu"]) == 1


def test_cli_defaults_to_the_card(monkeypatch, tmp_path):
    """Without --device the CLI renders on the card; where there is none it
    raises and writes nothing."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = str(tmp_path / "none")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["0", "1", "--size", "4", "--out", out])
    assert not os.path.exists(out + ".bmp")
