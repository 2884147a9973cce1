"""Host-side image writers: PPM (ASCII P3), BMP, Radiance HDR (RGBE).

The port's own copy of jet_pbrt_tpu/utils/image.py (numpy only), writing
the same bytes for the same image: the reference's film writers
(reference: src/film.cc:45-188), vectorised with numpy. The reference's PPM
writer streams uint8 values through operator<< so they land as raw chars
(reference: src/film.cc:45-60); this writes an ASCII P3 file instead, as
the reference package does.
"""
from __future__ import annotations

import struct

import numpy as np


def gamma_encode(img: np.ndarray) -> np.ndarray:
    """Linear [H,W,3] float -> uint8 with gamma 1/2.2 + 0.5 rounding
    (reference: src/film.h:24)."""
    img = np.clip(np.asarray(img, dtype=np.float64), 0.0, 1.0)
    return (np.power(img, 1.0 / 2.2) * 255.0 + 0.5).astype(np.uint8)


def write_ppm(path: str, img: np.ndarray) -> None:
    """ASCII P3 PPM from linear [H,W,3] float."""
    u8 = gamma_encode(img)
    h, w, _ = u8.shape
    flat = u8.reshape(-1, 3)
    with open(path, "w") as f:
        f.write(f"P3\n{w} {h}\n255\n")
        np.savetxt(f, flat, fmt="%d")


def write_bmp(path: str, img: np.ndarray) -> None:
    """24-bit BMP: 54-byte header, BGR, bottom-up rows, 4-byte row padding —
    the same file layout the reference hand-packs (reference: src/film.cc:62-144)."""
    u8 = gamma_encode(img)
    h, w, _ = u8.shape
    row_bytes = (w * 3 + 3) & ~3
    data_size = row_bytes * h
    file_size = 54 + data_size
    header = struct.pack(
        "<2sIHHIIiiHHIIiiII",
        b"BM", file_size, 0, 0, 54,      # BITMAPFILEHEADER
        40, w, h, 1, 24, 0, data_size,   # BITMAPINFOHEADER
        0, 0, 0, 0,
    )
    bgr = u8[::-1, :, ::-1]              # bottom-up rows, BGR channel order
    rows = np.zeros((h, row_bytes), dtype=np.uint8)
    rows[:, : w * 3] = bgr.reshape(h, w * 3)
    with open(path, "wb") as f:
        f.write(header)
        f.write(rows.tobytes())


def _rgbe(img: np.ndarray) -> np.ndarray:
    """Vectorized float RGB -> RGBE shared-exponent encoding
    (reference: src/film.cc:147-165, via frexp)."""
    img = np.asarray(img, dtype=np.float64)
    maxc = img.max(axis=-1)
    mantissa, exponent = np.frexp(maxc)
    scale = np.where(maxc >= 1e-32, mantissa * 256.0 / np.maximum(maxc, 1e-300), 0.0)
    rgbe = np.zeros(img.shape[:-1] + (4,), dtype=np.uint8)
    valid = maxc >= 1e-32
    rgbe[..., :3] = np.clip(img * scale[..., None], 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(valid, exponent + 128, 0).astype(np.uint8)
    rgbe[~valid] = 0
    return rgbe


def write_hdr(path: str, img: np.ndarray) -> None:
    """Radiance .hdr, flat (non-RLE) RGBE scanlines — the same output form as
    the reference writer (reference: src/film.cc:168-188)."""
    img = np.asarray(img, dtype=np.float64)
    h, w, _ = img.shape
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\n")
        f.write(b"FORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(_rgbe(img).tobytes())


def read_ppm(path: str) -> np.ndarray:
    """Read back an ASCII P3 PPM into linear float (inverse gamma)."""
    with open(path) as f:
        tokens = f.read().split()
    assert tokens[0] == "P3"
    w, h, maxv = int(tokens[1]), int(tokens[2]), int(tokens[3])
    vals = np.array(tokens[4:], dtype=np.float64).reshape(h, w, 3) / maxv
    return np.power(vals, 2.2).astype(np.float32)


def save_image(path_base: str, img: np.ndarray, fmt: str = "bmp") -> str:
    """Dispatch like FFilm::SaveAsImage (reference: src/film.cc:11-43)."""
    fmt = fmt.lower()
    path = f"{path_base}.{fmt}"
    if fmt == "ppm":
        write_ppm(path, img)
    elif fmt == "bmp":
        write_bmp(path, img)
    elif fmt == "hdr":
        write_hdr(path, img)
    else:
        raise ValueError(f"unknown image format: {fmt}")
    return path
