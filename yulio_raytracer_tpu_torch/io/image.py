"""Image load/store — the `common/image` layer.

The torch package's own copy of `yulio_raytracer_tpu/io/image.py`.  The
reference dispatches codecs by extension with an image cache
(`image/image.cpp:61-95`, caches in `loaders.cpp:29-66`).  We keep the
dispatch + cache shape: PPM/PFM are decoded natively (exact semantics,
`ppm.cpp` / `pfm.cpp`), everything else goes through Pillow (the
C-backed host-side equivalent of FreeImage/libjpeg-turbo), imported only
when such a file is read or written.
Returns float32 RGB(A) arrays in [0,1] (LDR) or linear radiance (PFM).
"""
from __future__ import annotations

import os

import numpy as np

_cache: dict = {}


def load(path: str) -> np.ndarray:
    """Load an image as (H, W, 3|4) float32. Cached by absolute path,
    mirroring rtLoadImage's filename cache (loaders.cpp:29-43)."""
    key = os.path.abspath(path)
    if key in _cache:
        return _cache[key]
    ext = os.path.splitext(path)[1].lower()
    if ext == '.ppm':
        img = _load_ppm(path)
    elif ext == '.pfm':
        img = _load_pfm(path)
    elif ext == '.exr':
        from . import exr
        img = exr.load_exr(path)
    else:
        from PIL import Image
        with Image.open(path) as im:
            if im.mode not in ('RGB', 'RGBA'):
                im = im.convert('RGBA' if 'A' in im.getbands() else 'RGB')
            img = np.asarray(im).astype(np.float32) / 255.0
    _cache[key] = img
    return img


def store(path: str, img: np.ndarray, jpeg_quality: int = 90):
    """Store u8 or float image; float is clamped+quantized for LDR formats
    (storeImage dispatch, image.cpp:77-95)."""
    ext = os.path.splitext(path)[1].lower()
    arr = np.asarray(img)
    if ext == '.pfm':
        _store_pfm(path, arr.astype(np.float32))
        return
    if ext == '.exr':
        from . import exr
        exr.store_exr(path, arr.astype(np.float32))
        return
    if arr.dtype != np.uint8:
        arr = np.clip(arr * 255.0 + 0.5, 0, 255).astype(np.uint8)
    if ext == '.ppm':
        _store_ppm(path, arr)
        return
    from PIL import Image
    im = Image.fromarray(arr)
    if ext in ('.jpg', '.jpeg'):
        if im.mode == 'RGBA':
            im = im.convert('RGB')
        im.save(path, quality=jpeg_quality)
    else:
        im.save(path)


def _tokens(f):
    """PPM header tokenizer with '#' comments."""
    while True:
        line = f.readline()
        if not line:
            return
        line = line.split(b'#')[0]
        for t in line.split():
            yield t


def _load_ppm(path: str) -> np.ndarray:
    with open(path, 'rb') as f:
        tok = _tokens(f)
        magic = next(tok)
        if magic not in (b'P6', b'P3'):
            raise ValueError(f"unsupported PPM magic {magic!r}")
        w = int(next(tok))
        h = int(next(tok))
        maxval = int(next(tok))
        if magic == b'P6':
            data = np.frombuffer(f.read(w * h * 3), np.uint8)
        else:
            data = np.asarray([int(next(tok)) for _ in range(w * h * 3)],
                              np.uint8)
        return (data.reshape(h, w, 3).astype(np.float32) / maxval)


def _store_ppm(path: str, arr: np.ndarray):
    h, w = arr.shape[:2]
    with open(path, 'wb') as f:
        f.write(b'P6\n%d %d\n255\n' % (w, h))
        f.write(arr[..., :3].tobytes())


def _load_pfm(path: str) -> np.ndarray:
    with open(path, 'rb') as f:
        magic = f.readline().strip()
        if magic not in (b'PF', b'Pf'):
            raise ValueError("not a PFM file")
        w, h = map(int, f.readline().split())
        scale = float(f.readline())
        ch = 3 if magic == b'PF' else 1
        data = np.frombuffer(f.read(w * h * ch * 4), np.float32)
        if scale > 0:          # big-endian
            data = data.byteswap()
        img = data.reshape(h, w, ch)[::-1]  # PFM rows are bottom-up
        if ch == 1:
            img = img[..., None].repeat(3, -1).reshape(h, w, 3)
        return np.ascontiguousarray(img)


def _store_pfm(path: str, arr: np.ndarray):
    h, w = arr.shape[:2]
    with open(path, 'wb') as f:
        f.write(b'PF\n%d %d\n-1.0\n' % (w, h))
        f.write(np.ascontiguousarray(arr[::-1, :, :3], np.float32).tobytes())


def clear_cache():
    _cache.clear()
