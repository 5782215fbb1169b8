"""Stereo cube-map output: watermark compositing and 12-face strip assembly.

Counterpart of `yulio_raytracer_tpu/film/stereo_strip.py`: the Yulio
outputMode pipeline (`renderer.cpp:508-736`) as array ops over the 12
rendered faces:

* watermark: alpha-blended, centered, only on the four side faces
  (front/right/back/left, face % 6 < 4, renderer.cpp:636-654);
* strip: a 12W x H image in segment order left, right, up, down, back,
  front (6 segments per eye), with the reference's eye-swap quirk:
  segment group 0 takes the RIGHT-eye faces (eyeIndex = segment/6 == 0
  ? 1 : 0, renderer.cpp:677);
* per-face debug file names `<scene>_<camera>_<face>_image_<eye>.jpg`
  (renderer.cpp:587-620).

The watermark ships as the package's own 100x100 RGBA PNG and is decoded
here with zlib alone (`decode_png`), the analog of the reference DLL's
decode from memory (renderer.cpp:48-97); nothing needs Pillow.
"""
from __future__ import annotations

import os
import struct
import zlib

import numpy as np

# strip segment -> cube face offset (renderer.cpp:684-714)
_SEGMENT_TO_FACE = [3, 1, 4, 5, 2, 0]   # left right up down back front
FACE_NAMES = ['front', 'right', 'back', 'left', 'top', 'bottom']
WATERMARK_PNG = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'resources', 'watermark_100x100.png')


def apply_watermark(face_img: np.ndarray, watermark: np.ndarray,
                    face_index: int) -> np.ndarray:
    """Alpha-blend the watermark centered on a face (renderer.cpp:636-654).

    face_img: (H, W, 3|4) float; watermark: (h, w, 4) float with alpha.
    Only faces with face_index % 6 < 4 are watermarked.
    """
    if face_index % 6 >= 4 or watermark is None:
        return face_img
    out = np.array(face_img, copy=True)
    h, w = face_img.shape[:2]
    wh, ww = watermark.shape[:2]
    x0 = int((w - ww) * 0.5)
    y0 = int((h - wh) * 0.5)
    xs0, ys0 = max(0, x0), max(0, y0)
    xs1, ys1 = min(w, x0 + ww), min(h, y0 + wh)
    if xs1 <= xs0 or ys1 <= ys0:
        return out
    sub = out[ys0:ys1, xs0:xs1]
    wm = watermark[ys0 - y0:ys1 - y0, xs0 - x0:xs1 - x0]
    a = wm[..., 3:4]
    out[ys0:ys1, xs0:xs1, :3] = (1.0 - a) * sub[..., :3] + a * wm[..., :3]
    if out.shape[-1] == 4:
        out[ys0:ys1, xs0:xs1, 3:4] = (1.0 - a) * sub[..., 3:4] + a * a
    return out


def assemble_strip(faces: list) -> np.ndarray:
    """Assemble the 12 face images (indexed 0..11 = 6 left-eye then 6
    right-eye, face order front, right, back, left, up, down) into the
    12W x H strip (renderer.cpp:665-716), with the eye-swap quirk."""
    assert len(faces) == 12
    segments = []
    for segment in range(12):
        eye_index = 1 if segment // 6 == 0 else 0     # the quirk (:677)
        segments.append(faces[6 * eye_index
                              + _SEGMENT_TO_FACE[segment % 6]])
    return np.concatenate(segments, axis=1)


def face_filename(scene_base: str, camera_name: str, face_index: int) -> str:
    """Per-face debug JPEG name (renderer.cpp:587-620)."""
    eye = 'left' if face_index < 6 else 'right'
    return (f"{scene_base}_{camera_name}_"
            f"{FACE_NAMES[face_index % 6]}_image_{eye}.jpg")


def strip_filename(scene_base: str, camera_name: str) -> str:
    """The cube-map strip's name `<scene>_<camera>.jpg` (renderer.cpp:717)."""
    return f"{scene_base}_{camera_name}.jpg"


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def decode_png(data: bytes) -> np.ndarray:
    """A PNG of 8-bit RGB or RGBA samples, not interlaced, as (H, W, 3|4)
    uint8: its IDAT stream inflated with zlib, each row un-filtered (None,
    Sub, Up, Average, Paeth).  Raises ValueError for any other PNG."""
    if data[:8] != b'\x89PNG\r\n\x1a\n':
        raise ValueError("not a PNG file")
    pos, ihdr, idat = 8, None, []
    while pos + 8 <= len(data):
        length, kind = struct.unpack('>I4s', data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b'IHDR':
            ihdr = struct.unpack('>IIBBBBB', body)
        elif kind == b'IDAT':
            idat.append(body)
        elif kind == b'IEND':
            break
    if ihdr is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, comp, filt, interlace = ihdr
    if depth != 8 or ctype not in (2, 6) or comp or filt or interlace:
        raise ValueError(f"unsupported PNG: bit depth {depth}, colour type "
                         f"{ctype}, interlace {interlace} (8-bit RGB or "
                         "RGBA, not interlaced, is read)")
    bpp = 3 if ctype == 2 else 4
    stride = w * bpp
    raw = zlib.decompress(b''.join(idat))
    if len(raw) != h * (stride + 1):
        raise ValueError("PNG image data of the wrong size")
    out = bytearray(h * stride)
    prev = bytearray(stride)
    for y in range(h):
        ftype = raw[y * (stride + 1)]
        row = bytearray(raw[y * (stride + 1) + 1:(y + 1) * (stride + 1)])
        if ftype == 1:
            for i in range(bpp, stride):
                row[i] = (row[i] + row[i - bpp]) & 0xFF
        elif ftype == 2:
            for i in range(stride):
                row[i] = (row[i] + prev[i]) & 0xFF
        elif ftype == 3:
            for i in range(stride):
                left = row[i - bpp] if i >= bpp else 0
                row[i] = (row[i] + ((left + prev[i]) >> 1)) & 0xFF
        elif ftype == 4:
            for i in range(stride):
                left = row[i - bpp] if i >= bpp else 0
                up_left = prev[i - bpp] if i >= bpp else 0
                row[i] = (row[i] + _paeth(left, prev[i], up_left)) & 0xFF
        elif ftype != 0:
            raise ValueError(f"PNG row filter {ftype} is not one of 0-4")
        out[y * stride:(y + 1) * stride] = row
        prev = row
    return np.frombuffer(bytes(out), np.uint8).reshape(h, w, bpp)


def load_watermark(path: str = WATERMARK_PNG) -> np.ndarray:
    """The watermark as (h, w, 4) float32 RGBA in [0, 1] (an RGB file gets
    alpha 1): the package's PNG resource unless `path` names another.
    A file decode_png cannot read raises; nothing falls back to the
    procedural glyph."""
    with open(path, 'rb') as f:
        px = decode_png(f.read())
    if px.shape[-1] == 3:
        px = np.concatenate([px, np.full(px.shape[:2] + (1,), 255,
                                         np.uint8)], axis=-1)
    return px.astype(np.float32) / 255.0


def default_watermark(size: int = 100) -> np.ndarray:
    """The reference's procedural glyph: a translucent white 'Y' on a
    transparent background, size x size."""
    wm = np.zeros((size, size, 4), np.float32)
    c = size // 2
    for y in range(size):
        for x in range(size):
            # stem
            if abs(x - c) < size * 0.06 and y > c:
                wm[y, x] = (1, 1, 1, 0.35)
            # arms
            dy = y - size * 0.2
            if 0 <= dy <= c * 0.7:
                if abs((x - c) + (dy - c * 0.35)) < size * 0.07 \
                        or abs((x - c) - (dy - c * 0.35)) < size * 0.07:
                    wm[y, x] = (1, 1, 1, 0.35)
    return wm
