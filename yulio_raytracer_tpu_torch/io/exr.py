"""Native OpenEXR 2.0 scanline codec (pure numpy + zlib).

The torch package's own copy of `yulio_raytracer_tpu/io/exr.py`, so that
an HDRILight can read `.exr` maps.  The reference wraps the OpenEXR library (`common/image/exr.cpp`:
ImfInputFile / ImfRgbaOutputFile, HALF RGB(A), scanline storage).  This
module implements the same on-disk format natively so HDR environment
maps (.exr HDRIs) and HDR output work without any external dependency:

* read: scanline EXRs, HALF/FLOAT/UINT channels, NONE / ZIPS (1-line) /
  ZIP (16-line) compression, arbitrary channel sets (R,G,B[,A] selected,
  Y promoted to RGB), increasing/decreasing line order, dataWindow
  offsets.
* write: HALF RGB(A), ZIP compression (the exr.cpp write path uses
  WRITE_RGBA, which is HALF RGBA).

Format reference: OpenEXRFileLayout (openexr.com, public spec).
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_MAGIC = 20000630          # 0x76 0x2f 0x31 0x01 little-endian
_PT_UINT, _PT_HALF, _PT_FLOAT = 0, 1, 2
_PT_DTYPE = {_PT_UINT: np.uint32, _PT_HALF: np.float16,
             _PT_FLOAT: np.float32}
_COMP_NONE, _COMP_RLE, _COMP_ZIPS, _COMP_ZIP, _COMP_PIZ = 0, 1, 2, 3, 4
_BLOCK_LINES = {_COMP_NONE: 1, _COMP_ZIPS: 1, _COMP_ZIP: 16}


def _read_cstring(buf: bytes, pos: int):
    end = buf.index(b'\0', pos)
    return buf[pos:end].decode('latin-1'), end + 1


def _predictor_decode(raw: bytes) -> bytes:
    """EXR zip post-inflate reconstruction: delta-decode then
    de-interleave the two halves."""
    d = np.frombuffer(raw, np.uint8).astype(np.int32)
    d = (np.cumsum(d - 128, dtype=np.int64) + 128).astype(np.uint8)
    n = len(d)
    out = np.empty(n, np.uint8)
    half = (n + 1) // 2
    out[0::2] = d[:half]
    out[1::2] = d[half:]
    return out.tobytes()


def _predictor_encode(raw: bytes) -> bytes:
    """Inverse of _predictor_decode: interleave-split then delta-encode."""
    d = np.frombuffer(raw, np.uint8)
    n = len(d)
    t = np.empty(n, np.uint8)
    half = (n + 1) // 2
    t[:half] = d[0::2]
    t[half:] = d[1::2]
    ti = t.astype(np.int32)
    delta = np.empty(n, np.int32)
    delta[0] = ti[0]
    delta[1:] = ti[1:] - ti[:-1] + 128
    return delta.astype(np.uint8).tobytes()


def _parse_header(buf: bytes, pos: int):
    attrs = {}
    while True:
        if buf[pos] == 0:       # empty name terminates the header
            return attrs, pos + 1
        name, pos = _read_cstring(buf, pos)
        typ, pos = _read_cstring(buf, pos)
        size = struct.unpack_from('<i', buf, pos)[0]
        pos += 4
        attrs[name] = (typ, buf[pos:pos + size])
        pos += size


def _parse_channels(data: bytes):
    """chlist: [(name, pixel_type, x_sampling, y_sampling), ...]"""
    chans = []
    pos = 0
    while data[pos] != 0:
        name, pos = _read_cstring(data, pos)
        ptype, xs, ys = struct.unpack_from('<i4xii', data, pos)
        pos += 16
        chans.append((name, ptype, xs, ys))
    return chans


def load_exr(path: str) -> np.ndarray:
    """Load a scanline EXR as (H, W, 3|4) float32 linear radiance."""
    with open(path, 'rb') as f:
        buf = f.read()
    magic, version = struct.unpack_from('<ii', buf, 0)
    if magic != _MAGIC:
        raise ValueError(f"{path}: not an EXR file")
    if version & 0x200:
        raise ValueError(f"{path}: tiled EXR not supported (scanline only)")
    if version & 0x1000 or version & 0x800:
        raise ValueError(f"{path}: multi-part/deep EXR not supported")
    attrs, pos = _parse_header(buf, 8)

    comp = attrs['compression'][1][0]
    if comp not in _BLOCK_LINES:
        raise ValueError(f"{path}: unsupported compression {comp} "
                         "(NONE/ZIP/ZIPS only)")
    xmin, ymin, xmax, ymax = struct.unpack('<4i', attrs['dataWindow'][1])
    w, h = xmax - xmin + 1, ymax - ymin + 1
    increasing = attrs.get('lineOrder', (None, b'\0'))[1][0] == 0
    chans = _parse_channels(attrs['channels'][1])
    for name, _, xs, ys in chans:
        if xs != 1 or ys != 1:
            raise ValueError(f"{path}: subsampled channel {name}")

    lines_per_block = _BLOCK_LINES[comp]
    n_blocks = (h + lines_per_block - 1) // lines_per_block
    offsets = np.frombuffer(buf, np.uint64, n_blocks, pos)

    # bytes per pixel per channel, channel order as stored (alphabetical)
    ch_dtypes = [np.dtype(_PT_DTYPE[pt]).newbyteorder('<')
                 for _, pt, _, _ in chans]
    line_bytes = sum(w * dt.itemsize for dt in ch_dtypes)
    planes = {name: np.zeros((h, w), np.float32)
              for name, _, _, _ in chans}

    for off in offsets.astype(np.int64):
        y0, size = struct.unpack_from('<ii', buf, off)
        data = buf[off + 8:off + 8 + size]
        y_rel = y0 - ymin
        n_lines = min(lines_per_block, h - y_rel)
        expect = line_bytes * n_lines
        if comp != _COMP_NONE and size < expect:
            data = _predictor_decode(zlib.decompress(data))
        p = 0
        for li in range(n_lines):
            y = y_rel + li if increasing else (h - 1 - (y_rel + li))
            for (name, _, _, _), dt in zip(chans, ch_dtypes):
                row = np.frombuffer(data, dt, w, p)
                planes[name][y] = row.astype(np.float32)
                p += w * dt.itemsize

    names = [c[0] for c in chans]
    if all(k in names for k in ('R', 'G', 'B')):
        out = [planes['R'], planes['G'], planes['B']]
        if 'A' in names:
            out.append(planes['A'])
    elif 'Y' in names:                      # luminance-only -> gray RGB
        out = [planes['Y']] * 3
    else:
        out = [planes[n] for n in names[:3]]
        while len(out) < 3:
            out.append(out[-1])
    return np.stack(out, axis=-1)


def _attr(name: bytes, typ: bytes, data: bytes) -> bytes:
    return name + b'\0' + typ + b'\0' + struct.pack('<i', len(data)) + data


def store_exr(path: str, img: np.ndarray, compression: str = 'zip'):
    """Store (H, W, 3|4) float as HALF RGB(A) scanline EXR."""
    arr = np.asarray(img, np.float32)
    if arr.ndim != 3 or arr.shape[2] not in (3, 4):
        raise ValueError("store_exr expects (H, W, 3|4)")
    h, w, nc = arr.shape
    comp = {'none': _COMP_NONE, 'zip': _COMP_ZIP, 'zips': _COMP_ZIPS}[
        compression]
    lines_per_block = _BLOCK_LINES[comp]

    # channels are stored in alphabetical order: (A,)B,G,R
    names = ['B', 'G', 'R'] if nc == 3 else ['A', 'B', 'G', 'R']
    src = {'R': arr[..., 0], 'G': arr[..., 1], 'B': arr[..., 2]}
    if nc == 4:
        src['A'] = arr[..., 3]
    chlist = b''.join(
        n.encode() + b'\0' + struct.pack('<i4xii', _PT_HALF, 1, 1)
        for n in names) + b'\0'

    box = struct.pack('<4i', 0, 0, w - 1, h - 1)
    header = b''.join([
        _attr(b'channels', b'chlist', chlist),
        _attr(b'compression', b'compression', bytes([comp])),
        _attr(b'dataWindow', b'box2i', box),
        _attr(b'displayWindow', b'box2i', box),
        _attr(b'lineOrder', b'lineOrder', b'\0'),
        _attr(b'pixelAspectRatio', b'float', struct.pack('<f', 1.0)),
        _attr(b'screenWindowCenter', b'v2f', struct.pack('<2f', 0, 0)),
        _attr(b'screenWindowWidth', b'float', struct.pack('<f', 1.0)),
    ]) + b'\0'

    half_rows = {n: src[n].astype('<f2') for n in names}
    blocks = []
    for y0 in range(0, h, lines_per_block):
        n_lines = min(lines_per_block, h - y0)
        raw = b''.join(half_rows[n][y0 + li].tobytes()
                       for li in range(n_lines) for n in names)
        if comp != _COMP_NONE:
            z = zlib.compress(_predictor_encode(raw))
            data = z if len(z) < len(raw) else raw
        else:
            data = raw
        blocks.append(struct.pack('<ii', y0, len(data)) + data)

    n_blocks = len(blocks)
    table_pos = 8 + len(header)
    data_pos = table_pos + 8 * n_blocks
    offsets = []
    for b in blocks:
        offsets.append(data_pos)
        data_pos += len(b)

    with open(path, 'wb') as f:
        f.write(struct.pack('<ii', _MAGIC, 2))
        f.write(header)
        f.write(np.asarray(offsets, np.uint64).tobytes())
        for b in blocks:
            f.write(b)
