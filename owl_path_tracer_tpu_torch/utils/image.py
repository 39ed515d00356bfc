"""Image IO: PNG framebuffer output, LDR textures (RGBA8) and Radiance HDR
environment maps.

Counterpart of ``owl_path_tracer_tpu/utils/image.py``.  The framebuffer is
quantized as owl's ``make_rgba`` does (``255.99 * clamp(c, 0, 1)``) and
written as an 8-bit RGBA PNG through PIL, as the JAX package writes it.
Textures are flipped vertically on load; the environment map is read as true
float HDR and flipped the same way.
"""
from __future__ import annotations

import pathlib

import numpy as np


def quantize_rgba8(rgb: np.ndarray) -> np.ndarray:
    """f32 [...,3] linear -> uint8 [...,4] with owl's make_rgba rounding."""
    q = (np.clip(rgb, 0.0, 1.0) * 255.99).astype(np.uint8)
    a = np.full(q.shape[:-1] + (1,), 255, np.uint8)
    return np.concatenate([q, a], axis=-1)


def write_png_rgba8(path, rgba: np.ndarray):
    """uint8 [H,W,4], row 0 = top of the image -> an 8-bit RGBA PNG."""
    from PIL import Image

    Image.fromarray(np.ascontiguousarray(rgba, np.uint8), "RGBA").save(str(path))


def write_png_rgb(path, rgb_f32: np.ndarray):
    write_png_rgba8(path, quantize_rgba8(rgb_f32))


def read_png(path) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(str(path)).convert("RGBA"))


def load_texture_rgba8(path, flip_vertical: bool = True) -> np.ndarray:
    """LDR texture, uint8 [H,W,4], flipped vertically on load."""
    img = read_png(path)
    if flip_vertical:
        img = img[::-1].copy()
    return img


def _rgbe_to_float(rgbe: np.ndarray) -> np.ndarray:
    """uint8 [H,W,4] RGBE -> f32 [H,W,3]."""
    rgbe = rgbe.astype(np.int32)
    exp = rgbe[..., 3]
    scale = np.where(exp == 0, 0.0, np.ldexp(1.0, exp - 128 - 8)).astype(np.float32)
    return rgbe[..., :3].astype(np.float32) * scale[..., None]


def _float_to_rgbe(rgb: np.ndarray) -> np.ndarray:
    """f32 [H,W,3] -> uint8 [H,W,4] RGBE."""
    maxc = rgb.max(axis=-1)
    mant, exp = np.frexp(maxc)
    scale = np.where(maxc > 1e-32, mant * 256.0 / np.maximum(maxc, 1e-32), 0.0)
    out = np.zeros(rgb.shape[:-1] + (4,), np.uint8)
    out[..., :3] = np.clip(rgb * scale[..., None] + 0.5, 0, 255).astype(np.uint8)
    out[..., 3] = np.where(maxc > 1e-32, exp + 128, 0).astype(np.uint8)
    return out


def write_hdr(path, rgb: np.ndarray):
    """Linear f32 [H,W,3] -> an uncompressed Radiance .hdr (``-Y H +X W``)."""
    h, w = rgb.shape[:2]
    header = f"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y {h} +X {w}\n".encode("latin-1")
    pathlib.Path(path).write_bytes(header + _float_to_rgbe(np.asarray(rgb, np.float32)).tobytes())


def read_hdr(path) -> np.ndarray:
    """Radiance .hdr (``-Y H +X W``, adaptive RLE or flat scanlines) -> f32 [H,W,3]."""
    data = pathlib.Path(path).read_bytes()
    pos = data.find(b"\n\n")  # the header ends at a blank line
    if pos < 0:
        raise ValueError("bad hdr header")
    header = data[:pos].decode("latin-1")
    if "32-bit_rle_rgbe" not in header and not header.startswith("#?"):
        raise ValueError("not an RGBE hdr file")
    body = data[pos + 2 :]
    nl = body.find(b"\n")
    dims = body[:nl].decode("latin-1").split()
    if dims[0] != "-Y" or dims[2] != "+X":
        raise ValueError(f"unsupported orientation {dims}")
    h, w = int(dims[1]), int(dims[3])
    buf = np.frombuffer(body[nl + 1 :], np.uint8)
    img = np.zeros((h, w, 4), np.uint8)
    p = 0
    for y in range(h):
        if w >= 8 and w < 32768 and p + 4 <= len(buf) and buf[p] == 2 and buf[p + 1] == 2:
            p += 4  # adaptive RLE scanline
            for c in range(4):
                x = 0
                while x < w:
                    count = int(buf[p])
                    p += 1
                    if count > 128:  # run
                        img[y, x : x + count - 128, c] = buf[p]
                        p += 1
                        x += count - 128
                    else:  # literal
                        img[y, x : x + count, c] = buf[p : p + count]
                        p += count
                        x += count
        else:
            img[y] = buf[p : p + w * 4].reshape(w, 4)
            p += w * 4
    return _rgbe_to_float(img)


def load_environment(path) -> np.ndarray:
    """Environment map -> linear f32 [H,W,3] (zeros [1,1,3] if the file is missing)."""
    p = pathlib.Path(path)
    if not p.exists():
        return np.zeros((1, 1, 3), np.float32)
    if p.suffix.lower() == ".hdr":
        return read_hdr(p)[::-1].copy()
    img = load_texture_rgba8(p)
    return img[..., :3].astype(np.float32) / 255.0
