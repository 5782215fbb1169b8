"""Distributed rendering over TCP: render servers and their client.

Counterpart of `yulio_raytracer_tpu/parallel/network.py` (the
reference's `device_network`):

* a render **server** wraps the local renderer and renders only its
  interleaved row bands, `((y >> 2) - serverID) % serverCount == 0`
  (swapchain.h:57-60); each band's pixels render at their own count,
  their samples summed as render_frame sums them (renderer._frame's
  `pixels`), so the merged frame is bit-equal to a local render.  The reference pads every band to a fixed chunk of 1 << 17
  rays, at which its trace gives a few rays other results than at the
  frame's own width; the port's trace does not depend on the width, and
  nothing is padded;
* a **client** connects to N servers, sends the scene and each render
  request to all of them, and merges the returned bands.

Wire protocol (as the reference's, so plain trees encode to the same
bytes): every frame is `MAGICK u32 | VERSION u16 | opcode u16 | length
u64 | crc32 u32 | payload`, the crc over the payload; the payload is a
restricted self-describing tree codec (None, bools, ints, floats,
strings, bytes, lists, tuples, dicts with str keys, numpy arrays and
torch tensors of whitelisted dtypes, and the scene classes `_registry`
names).  No pickle: a malformed or hostile peer gives a ConnectionError,
never code execution.

`OP_UPDATE_LIGHT` patches one light's parameters on the servers without
sending the scene again.  Replies come in one of three encodings:
'native' (f32 rows), 'rgbe8' (Ward's shared exponent, 4 bytes a pixel)
or 'jpeg' (lossy, Pillow's libjpeg, imported only when used); a
server's `-encode` overrides the client's choice.
"""
from __future__ import annotations

import socket
import struct
import threading
import zlib

import numpy as np
import torch

MAGICK = 0x32657845   # network_common.h:26
VERSION = 5           # the reference's: OP_RENDER with pixel_filter,
                      # backplate, view_pos and view_up
_FRAME = struct.Struct(">IHHQI")   # magick, version, opcode, len, crc32

# opcodes (network_common.h:29-80)
OP_HELLO = 1
OP_SET_SCENE = 2
OP_RENDER = 3
OP_FRAME = 4
OP_UPDATE_LIGHT = 5
OP_CLOSE = 6
OP_ERROR = 7

MAX_FRAME_BYTES = 1 << 33    # 8 GiB bound on a declared length


# --------------------------------------------------------------------------
# the tree codec (no pickle)
# --------------------------------------------------------------------------

_T_NONE, _T_BOOL, _T_INT, _T_FLOAT, _T_STR, _T_BYTES = 0, 1, 2, 3, 4, 5
_T_LIST, _T_TUPLE, _T_DICT, _T_NDARRAY, _T_DATACLASS = 6, 7, 8, 9, 10
_T_NAMEDTUPLE = 11
_T_TENSOR = 12     # the port's own: a torch tensor, decoded on the CPU

_DTYPE_WHITELIST = ('f4', 'f8', 'i4', 'i8', 'u1', 'u4', 'b1')


def _registry():
    """The dataclasses and named tuples allowed on the wire, by name
    (imported here, so the codec has no import cycle with them)."""
    from ..cameras import cameras as gcam
    from ..geometry.mesh import HostMesh
    from ..sampling.distribution import Distribution1D, Distribution2D
    from ..scene import SceneBuilder
    from ..shading.materials import LobeSpec, MaterialSpec
    from ..shading.textures import TextureTableBuilder
    return {c.__name__: c for c in (
        gcam.Pinhole, gcam.DepthOfField, gcam.StereoCube,
        HostMesh, LobeSpec, MaterialSpec, TextureTableBuilder,
        SceneBuilder, Distribution1D, Distribution2D)}


def _pack_array(tag, a: np.ndarray, out: bytearray):
    ds = a.dtype.str.lstrip('<>=|')
    if ds not in _DTYPE_WHITELIST:
        raise TypeError(f"dtype {a.dtype} not wire-whitelisted")
    a = np.ascontiguousarray(a)
    out.append(tag)
    _pack(ds, out)
    _pack(list(a.shape), out)
    raw = a.tobytes()
    out += struct.pack(">Q", len(raw)) + raw


def _pack(obj, out: bytearray):
    import dataclasses
    if obj is None:
        out.append(_T_NONE)
    elif isinstance(obj, (bool, np.bool_)):
        out.append(_T_BOOL)
        out.append(1 if obj else 0)
    elif isinstance(obj, (int, np.integer)):
        out.append(_T_INT)
        out += struct.pack(">q", int(obj))
    elif isinstance(obj, (float, np.floating)):
        out.append(_T_FLOAT)
        out += struct.pack(">d", float(obj))
    elif isinstance(obj, str):
        b = obj.encode()
        out.append(_T_STR)
        out += struct.pack(">I", len(b)) + b
    elif isinstance(obj, (bytes, bytearray)):
        out.append(_T_BYTES)
        out += struct.pack(">Q", len(obj)) + obj
    elif isinstance(obj, torch.Tensor):
        _pack_array(_T_TENSOR, obj.detach().cpu().numpy(), out)
    elif isinstance(obj, tuple) and hasattr(obj, '_fields'):
        name = type(obj).__name__
        if name not in _registry():
            raise TypeError(f"namedtuple {name} is not wire-registered")
        out.append(_T_NAMEDTUPLE)
        _pack(name, out)
        _pack(dict(zip(obj._fields, obj)), out)
    elif isinstance(obj, (list, tuple)):
        out.append(_T_LIST if isinstance(obj, list) else _T_TUPLE)
        out += struct.pack(">I", len(obj))
        for x in obj:
            _pack(x, out)
    elif isinstance(obj, dict):
        out.append(_T_DICT)
        out += struct.pack(">I", len(obj))
        for k, v in obj.items():
            if not isinstance(k, str):
                raise TypeError(f"wire dict keys must be str, got {k!r}")
            _pack(k, out)
            _pack(v, out)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        name = type(obj).__name__
        if name not in _registry():
            raise TypeError(f"dataclass {name} is not wire-registered")
        out.append(_T_DATACLASS)
        _pack(name, out)
        _pack({f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)
               if not f.name.startswith('_')}, out)
    else:
        _pack_array(_T_NDARRAY, np.asarray(obj), out)


def _unpack(buf: memoryview, pos: int):
    tag = buf[pos]
    pos += 1
    if tag == _T_NONE:
        return None, pos
    if tag == _T_BOOL:
        return bool(buf[pos]), pos + 1
    if tag == _T_INT:
        return struct.unpack_from(">q", buf, pos)[0], pos + 8
    if tag == _T_FLOAT:
        return struct.unpack_from(">d", buf, pos)[0], pos + 8
    if tag == _T_STR:
        (n,) = struct.unpack_from(">I", buf, pos)
        pos += 4
        return bytes(buf[pos:pos + n]).decode(), pos + n
    if tag == _T_BYTES:
        (n,) = struct.unpack_from(">Q", buf, pos)
        pos += 8
        return bytes(buf[pos:pos + n]), pos + n
    if tag in (_T_LIST, _T_TUPLE):
        (n,) = struct.unpack_from(">I", buf, pos)
        pos += 4
        xs = []
        for _ in range(n):
            x, pos = _unpack(buf, pos)
            xs.append(x)
        return (xs if tag == _T_LIST else tuple(xs)), pos
    if tag == _T_DICT:
        (n,) = struct.unpack_from(">I", buf, pos)
        pos += 4
        d = {}
        for _ in range(n):
            k, pos = _unpack(buf, pos)
            v, pos = _unpack(buf, pos)
            d[k] = v
        return d, pos
    if tag in (_T_NDARRAY, _T_TENSOR):
        ds, pos = _unpack(buf, pos)
        shape, pos = _unpack(buf, pos)
        if ds not in _DTYPE_WHITELIST:
            raise ConnectionError(f"non-whitelisted wire dtype {ds!r}")
        (n,) = struct.unpack_from(">Q", buf, pos)
        pos += 8
        a = np.frombuffer(bytes(buf[pos:pos + n]),
                          dtype=np.dtype(ds)).reshape(shape)
        return (torch.from_numpy(a.copy()) if tag == _T_TENSOR else a), \
            pos + n
    if tag in (_T_DATACLASS, _T_NAMEDTUPLE):
        name, pos = _unpack(buf, pos)
        fields, pos = _unpack(buf, pos)
        cls = _registry().get(name)
        if cls is None:
            raise ConnectionError(f"unknown wire dataclass {name!r}")
        return cls(**fields), pos
    raise ConnectionError(f"malformed wire payload (tag {tag})")


def encode_tree(obj) -> bytes:
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def decode_tree(data: bytes):
    """The tree encoded in data; ConnectionError for anything the codec
    does not produce (an unknown tag or class, a short or long
    payload)."""
    try:
        obj, pos = _unpack(memoryview(data), 0)
    except (IndexError, struct.error, ValueError, TypeError,
            UnicodeDecodeError) as e:
        raise ConnectionError(f"malformed wire payload ({e!r})") from e
    if pos != len(data):
        raise ConnectionError("trailing bytes in wire payload")
    return obj


# --------------------------------------------------------------------------
# framing
# --------------------------------------------------------------------------

def _send(sock: socket.socket, opcode: int, obj):
    payload = encode_tree(obj)
    crc = zlib.crc32(payload) & 0xFFFFFFFF
    sock.sendall(_FRAME.pack(MAGICK, VERSION, opcode, len(payload), crc)
                 + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(1 << 20, n - len(buf)))
        if not chunk:
            raise ConnectionError("peer disconnected")   # network.h:30
        buf += chunk
    return bytes(buf)


def _recv(sock: socket.socket):
    """(opcode, payload tree); ConnectionError for a wrong magick or
    version, an oversized frame or a corrupt payload (crc)."""
    magick, ver, op, n, crc = _FRAME.unpack(_recv_exact(sock, _FRAME.size))
    if magick != MAGICK:
        raise ConnectionError(f"bad magick {magick:#x}")
    if ver != VERSION:
        raise ConnectionError(f"wire version mismatch: {ver} != {VERSION}")
    if n > MAX_FRAME_BYTES:
        raise ConnectionError(f"oversized frame ({n} bytes)")
    payload = _recv_exact(sock, n)
    if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
        raise ConnectionError("payload checksum mismatch")
    return op, decode_tree(payload)


# --------------------------------------------------------------------------
# encodings
# --------------------------------------------------------------------------

def rgbe8_encode(rgb: np.ndarray) -> np.ndarray:
    """Ward's RGBE shared exponent (network_common.h:83-103):
    (..., 3) f32 -> (..., 4) u8."""
    v = rgb.max(axis=-1)
    mant, expo = np.frexp(np.maximum(v, 1e-32))
    scale = np.where(v >= 1e-32, mant * 256.0 / np.maximum(v, 1e-32), 0.0)
    out = np.zeros(rgb.shape[:-1] + (4,), np.uint8)
    out[..., :3] = np.clip(rgb * scale[..., None], 0, 255).astype(np.uint8)
    out[..., 3] = np.where(v >= 1e-32, expo + 128, 0).astype(np.uint8)
    return out


def rgbe8_decode(rgbe: np.ndarray) -> np.ndarray:
    e = rgbe[..., 3].astype(np.int32)
    f = np.where(e > 0, np.ldexp(1.0, e - 136), 0.0).astype(np.float32)
    return rgbe[..., :3].astype(np.float32) * f[..., None]


def jpeg_encode(rgb: np.ndarray, quality: int = 90) -> bytes:
    """The JPEG row-band tier (network_server.cpp:680-739): linear
    radiance through a gamma-2.2 transfer, so JPEG quantizes in display
    space; values above 1 clip."""
    import io
    from PIL import Image
    u8 = np.clip(np.power(np.maximum(rgb, 0.0), 1.0 / 2.2) * 255.0 + 0.5,
                 0, 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(u8).save(buf, format='JPEG', quality=int(quality))
    return buf.getvalue()


def jpeg_decode(data: bytes) -> np.ndarray:
    import io
    from PIL import Image
    with Image.open(io.BytesIO(data)) as im:
        u8 = np.asarray(im.convert('RGB'), np.float32)
    return np.power(u8 / 255.0, 2.2)


def active_rows(height: int, server_id: int, server_count: int) -> np.ndarray:
    """The reference's 4-row band interleave (swapchain.h:57-60)."""
    y = np.arange(height)
    return np.nonzero(((y >> 2) - server_id) % server_count == 0)[0]


# --------------------------------------------------------------------------
# server
# --------------------------------------------------------------------------

class RenderServer:
    """`network_server_main.cpp`: serve render requests until stopped,
    rendering on `device` (None: the card; raises without one)."""

    def __init__(self, port: int, host: str = '127.0.0.1',
                 single_connection: bool = False,
                 force_encoding: str = None, device=None):
        from ..scene import resolve_device
        self.device = resolve_device(device)
        self.port = port
        self.host = host
        self.single = single_connection
        # the -encode flag (network_server_main.cpp:58-75) overrides the
        # client's reply encoding
        self.force_encoding = ({'rgb_float32': 'native'}.get(
            force_encoding, force_encoding) if force_encoding else None)
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self.port = self._sock.getsockname()[1]
        self._sock.listen(4)
        self._stop = threading.Event()

    def serve_forever(self):
        """Serve one connection at a time until stop() (or after the
        first, with single_connection); a malformed peer's connection is
        dropped.  Closes the listening socket when it returns."""
        try:
            while not self._stop.is_set():
                try:
                    self._sock.settimeout(0.5)
                    conn, _ = self._sock.accept()
                except socket.timeout:
                    continue
                try:
                    self._serve_one(conn)
                except ConnectionError:
                    pass        # malformed or hostile peer: drop it
                finally:
                    conn.close()
                if self.single:
                    break
        finally:
            self._sock.close()

    def stop(self):
        self._stop.set()

    def _serve_one(self, conn):
        op, hello = _recv(conn)
        if op != OP_HELLO:
            raise ConnectionError("expected HELLO")
        server_id = hello['serverID']          # network_device.cpp:100-106
        server_count = hello['serverCount']
        state = {'scene': None}                # the committed scene
        while True:
            try:
                op, msg = _recv(conn)
            except ConnectionError:
                return
            if op == OP_SET_SCENE:
                state['builder'] = msg['builder']
                state['scene'] = None
            elif op == OP_UPDATE_LIGHT:
                # patch one light; the scene is committed again lazily
                light = state['builder'].lights[msg['index']]
                for k, v in msg['values'].items():
                    if k not in light:
                        raise ConnectionError(
                            f"unknown light parameter {k!r}")
                    light[k] = (np.asarray(v, np.float32)
                                if isinstance(light[k], np.ndarray)
                                else type(light[k])(v))
                state['scene'] = None
            elif op == OP_RENDER:
                try:
                    reply = self._render(state, msg, server_id,
                                         server_count)
                except ConnectionError:
                    raise
                except Exception as e:          # a render error: OP_ERROR
                    _send(conn, OP_ERROR, {'error': repr(e)})
                    continue
                _send(conn, OP_FRAME, reply)
            elif op == OP_CLOSE:
                return
            else:
                raise ConnectionError(f"unknown opcode {op}")

    def _render(self, state, msg, server_id, server_count):
        from .. import renderer as grenderer
        from ..integrator import pathtracer as pt

        if self.force_encoding is not None:
            msg = {**msg, 'encoding': self.force_encoding}
        # camera-aligned billboards face each request's view_pos: such a
        # scene is committed again when it changes (rtUpdatePrimitive +
        # rtCommit, renderer.cpp:550-559); any other keeps its commit
        vp = msg.get('view_pos')
        if vp is not None and not state['builder'].has_billboards():
            vp = None
        view_up = tuple(msg.get('view_up', (0.0, 1.0, 0.0)))
        vkey = None if vp is None else (tuple(np.asarray(vp).tolist()),
                                        view_up)
        if state['scene'] is None or state.get('view_key') != vkey:
            kw = {} if vp is None else dict(
                view_pos=np.asarray(vp, np.float64), view_up=view_up)
            state['scene'] = state['builder'].commit(device=self.device,
                                                     **kw)
            state['view_key'] = vkey
        w, h, spp = msg['width'], msg['height'], msg['spp']
        rows = active_rows(h, server_id, server_count)
        pix = (rows[:, None] * w + np.arange(w)[None, :]).reshape(-1)
        bp = msg.get('backplate')
        film, _ = grenderer._frame(
            state['scene'], msg['camera'], pt.PTParams(**msg['params']), w,
            h, spp, seed=msg.get('seed', 0), backplate=bp,
            pixel_filter=msg.get('pixel_filter', 'box'), pixels=pix)
        out = film.rgb_sum.reshape(h, w, 3)[torch.as_tensor(rows)]
        out = out.cpu().numpy()
        if msg.get('encoding') == 'rgbe8':
            return {'rows': rows, 'rgbe': rgbe8_encode(out),
                    'weight': float(spp)}
        if msg.get('encoding') == 'jpeg':
            # the wire carries radiance averaged over the samples
            return {'rows': rows,
                    'jpeg': jpeg_encode(out / max(spp, 1),
                                        msg.get('jpeg_quality', 90)),
                    'weight': float(spp)}
        return {'rows': rows, 'rgb': out, 'weight': float(spp)}


# --------------------------------------------------------------------------
# client
# --------------------------------------------------------------------------

class NetworkClient:
    """`NetworkDevice`: send the scene and each render to every server,
    merge their bands."""

    def __init__(self, addresses: list, connect_timeout: float = 30.0):
        self.socks = []
        for i, (host, port) in enumerate(addresses):
            s = socket.create_connection((host, port),
                                         timeout=connect_timeout)
            # only the connect is bounded: a render may take minutes
            s.settimeout(None)
            _send(s, OP_HELLO, {'serverID': i,
                                'serverCount': len(addresses)})
            self.socks.append(s)

    def set_scene(self, builder):
        for s in self.socks:
            _send(s, OP_SET_SCENE, {'builder': builder})

    def update_light(self, index: int, **values):
        """Edit one light on every server without sending the scene again
        (e.g. client.update_light(0, L=(2.0, 2.0, 2.0)))."""
        for s in self.socks:
            _send(s, OP_UPDATE_LIGHT, {'index': index, 'values': values})

    def render(self, camera, params, width, height, spp, seed=0,
               encoding: str = 'native', jpeg_quality: int = 90,
               pixel_filter: str = 'box', backplate=None,
               view_pos=None, view_up=(0.0, 1.0, 0.0)):
        """One frame of spp samples a pixel over the servers.  encoding:
        'native' (f32 rows), 'rgbe8' (4 bytes a pixel) or 'jpeg' (at
        jpeg_quality 1-100); view_pos/view_up orient camera-aligned
        billboards (the servers commit again when they change).  Returns
        (the radiance sums (H, W, 3) f32, the weights (H, W) f32), on
        the host; ConnectionError when a server fails."""
        msg = {'camera': camera,
               'params': {**params.__dict__}, 'width': width,
               'height': height, 'spp': spp, 'seed': seed,
               'encoding': encoding, 'jpeg_quality': jpeg_quality,
               'pixel_filter': pixel_filter,
               'backplate': (None if backplate is None
                             else np.asarray(backplate, np.float32)),
               'view_pos': (None if view_pos is None
                            else np.asarray(view_pos, np.float32)),
               'view_up': tuple(view_up)}
        for s in self.socks:
            _send(s, OP_RENDER, msg)
        img = np.zeros((height, width, 3), np.float32)
        weight = np.zeros((height, width), np.float32)
        results = [None] * len(self.socks)
        errors = [None] * len(self.socks)

        def fetch(i):
            try:
                op, r = _recv(self.socks[i])
                if op == OP_ERROR:
                    raise ConnectionError(r.get('error', 'remote error'))
                if op != OP_FRAME:
                    raise ConnectionError(f"unexpected opcode {op}")
                results[i] = r
            except Exception as e:           # raised below, not dropped
                errors[i] = e

        threads = [threading.Thread(target=fetch, args=(i,))
                   for i in range(len(self.socks))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for i, e in enumerate(errors):
            if e is not None:
                raise ConnectionError(f"server {i} failed: {e!r}") from e
        for r in results:
            if 'rgbe' in r:
                band = rgbe8_decode(r['rgbe'])
            elif 'jpeg' in r:
                band = jpeg_decode(r['jpeg']) * r['weight']
            else:
                band = r['rgb']
            img[np.asarray(r['rows'])] = band
            weight[np.asarray(r['rows'])] = r['weight']
        return img, weight

    def close(self):
        for s in self.socks:
            try:
                _send(s, OP_CLOSE, {})
                s.close()
            except OSError:
                pass


# --------------------------------------------------------------------------
# the server's command line (network_server_main.cpp:43-112)
# --------------------------------------------------------------------------

def main(argv=None):
    """`rt_server`: python -m yulio_raytracer_tpu_torch.parallel.network
    -port 8282 [-host 0.0.0.0] [-encode native|rgbe8|jpeg] [-device cpu]
    [-threads N] [-single-connection] [-verbose].  It renders on the card
    unless -device names another device (cpu: the plain torch
    versions); -threads and -verbose are accepted, as the reference's
    flags, and unused."""
    import argparse
    ap = argparse.ArgumentParser(prog='rt_server')
    ap.add_argument('-port', '--port', type=int, default=8282)
    ap.add_argument('-host', '--host', default='0.0.0.0')
    ap.add_argument('-encode', '--encode', default=None,
                    choices=('native', 'rgb_float32', 'rgbe8', 'jpeg'))
    ap.add_argument('-threads', '--threads', type=int, default=0)
    ap.add_argument('-device', '--device', default=None)
    ap.add_argument('-single-connection', '--single-connection',
                    dest='single', action='store_true')
    ap.add_argument('-verbose', '--verbose', action='store_true')
    args = ap.parse_args(argv)

    server = RenderServer(args.port, host=args.host,
                          single_connection=args.single,
                          force_encoding=args.encode,
                          device=args.device)
    print(f"rt_server listening on {args.host}:{server.port} "
          f"({server.device})"
          + (f" (encode={args.encode})" if args.encode else ""), flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.stop()
    return 0


if __name__ == '__main__':
    import sys
    sys.exit(main())
