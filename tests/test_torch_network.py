"""The torch port's TCP render tier (parallel/network.py) held against its
own local renders and the JAX package on the CPU: local servers on free
ports, one client.

Tolerances: the band interleave, RGBE8 and the tree codec's bytes of
plain trees equal to the JAX package's; the merged film of two servers
bit-equal to the port's local film (and so within atol 1e-5, the bar of
the JAX package's test_two_server_render_matches_local); 'rgbe8' within
its codec's error, max channel / 128 a pixel; 'jpeg' at quality 95 with
a median display-space error < 0.05; the CLI's files over TCP equal to
its local files, byte for byte.
"""
import os
import socket
import threading
import time

import numpy as np
import pytest
import torch

from yulio_raytracer_tpu.parallel import network as jnetwork

from yulio_raytracer_tpu_torch import renderer
from yulio_raytracer_tpu_torch.api import cli
from yulio_raytracer_tpu_torch.cameras import cameras as gcam
from yulio_raytracer_tpu_torch.integrator import pathtracer as pt
from yulio_raytracer_tpu_torch.io import builtin_scenes as bs
from yulio_raytracer_tpu_torch.io import collada, ecs
from yulio_raytracer_tpu_torch.lights import lights as gl
from yulio_raytracer_tpu_torch.parallel import network
from yulio_raytracer_tpu_torch.scene import SceneBuilder

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = os.path.join(ROOT, 'assets', 'scenes')


def _servers(n, **kw):
    """n CPU servers on free ports, serving one connection each."""
    servers = [network.RenderServer(0, single_connection=True, device='cpu',
                                    **kw) for _ in range(n)]
    for s in servers:
        threading.Thread(target=s.serve_forever, daemon=True).start()
    return servers


def _client(servers):
    return network.NetworkClient([('127.0.0.1', s.port) for s in servers])


def _local(sb, camera, params, w, h, spp, seed, **kw):
    film, _ = renderer.render_frame(sb.commit(device='cpu', **kw), camera,
                                    params, w, h, spp, seed=seed)
    return film.rgb_sum.numpy()


@pytest.mark.parametrize('h,n', [(64, 3), (37, 2), (8, 5)])
def test_active_rows_equal_jax(h, n):
    rows = [network.active_rows(h, i, n) for i in range(n)]
    for i in range(n):
        np.testing.assert_array_equal(rows[i], jnetwork.active_rows(h, i, n))
    assert sorted(np.concatenate(rows).tolist()) == list(range(h))


def test_rgbe8_equal_jax():
    rs = np.random.RandomState(0)
    rgb = (rs.rand(16, 16, 3) * 50).astype(np.float32)
    rgb[0, 0] = 0.0
    rgb[1, 1] = 1e-35
    enc = network.rgbe8_encode(rgb)
    np.testing.assert_array_equal(enc, jnetwork.rgbe8_encode(rgb))
    dec = network.rgbe8_decode(enc)
    np.testing.assert_array_equal(dec, jnetwork.rgbe8_decode(enc))
    bound = rgb.max(axis=-1, keepdims=True) / 128.0 + 1e-6
    assert (np.abs(dec - rgb) <= bound).all()
    np.testing.assert_array_equal(dec[0, 0], 0.0)


def test_plain_tree_bytes_equal_jax():
    """Plain trees (dicts, lists, tuples, scalars, strings, bytes, arrays
    of every whitelisted dtype) encode to the JAX package's bytes and
    decode back."""
    rs = np.random.RandomState(1)
    tree = {'a': [1, -2, 3.5, None, True, 'x', b'\x00\xff'],
            'b': (np.float32(2.5), np.int64(7), np.bool_(False)),
            'arrays': [rs.rand(3, 4).astype(np.float32), rs.rand(2),
                       np.arange(6, dtype=np.int32).reshape(2, 3),
                       np.arange(4, dtype=np.int64),
                       np.arange(5, dtype=np.uint8),
                       np.arange(3, dtype=np.uint32),
                       np.array([True, False])],
            'nested': {'k': {'deeper': [[], {}, ()]}}}
    data = network.encode_tree(tree)
    assert data == jnetwork.encode_tree(tree)
    back = network.decode_tree(data)
    for x, y in zip(back['arrays'], tree['arrays']):
        np.testing.assert_array_equal(x, y)
        assert x.dtype == y.dtype
    assert back['a'] == tree['a'] and back['nested'] == tree['nested']


def test_codec_round_trips_scene_and_camera():
    """The port's scene builder and cameras (their tensors included)
    round-trip; a pickle payload, an unregistered class, a bad dtype and
    a truncated payload raise ConnectionError."""
    sb = bs.cornell_box()
    sb2 = network.decode_tree(network.encode_tree(sb))
    assert len(sb2.meshes) == len(sb.meshes)
    assert len(sb2.lights) == len(sb.lights)
    np.testing.assert_array_equal(sb2.meshes[0].positions,
                                  sb.meshes[0].positions)
    for cam in (bs.cornell_camera(8, 8),
                gcam.make_stereo_rig(gcam.look_at((0, 0, 0), (0, 0, 1),
                                                  (0, 1, 0)))[5]):
        cam2 = network.decode_tree(network.encode_tree(cam))
        assert type(cam2) is type(cam)
        assert torch.equal(cam2.local2world, cam.local2world)
    with pytest.raises(ConnectionError):
        network.decode_tree(b'\x80\x04K\x01.')
    bad = bytearray(network.encode_tree(bs.cornell_camera(8, 8)))
    name = b'Pinhole'
    bad[bad.index(name):bad.index(name) + len(name)] = b'Popen__'
    with pytest.raises(ConnectionError):
        network.decode_tree(bytes(bad))
    arr = bytearray(network.encode_tree(np.zeros(2, np.float32)))
    arr[arr.index(b'f4'):arr.index(b'f4') + 2] = b'O8'
    with pytest.raises(ConnectionError):
        network.decode_tree(bytes(arr))
    with pytest.raises(ConnectionError):
        network.decode_tree(network.encode_tree({'x': [1, 2]})[:-3])


def test_two_servers_merge_to_local_film():
    """Two servers' bands merge to the port's local film: bit-equal (no
    band is padded), so within the JAX test's atol 1e-5; 'rgbe8' within
    its codec error; 'jpeg' at quality 95 close in display space."""
    servers = _servers(2)
    sb = bs.cornell_box(with_boxes=False)
    camera, params = bs.cornell_camera(32, 32), pt.PTParams(max_depth=2)
    client = _client(servers)
    client.set_scene(sb)
    img, weight = client.render(camera, params, 32, 32, spp=2, seed=3)
    img8, w8 = client.render(camera, params, 32, 32, spp=2, seed=3,
                             encoding='rgbe8')
    imgj, wj = client.render(camera, params, 32, 32, spp=2, seed=3,
                             encoding='jpeg', jpeg_quality=95)
    client.close()
    assert (weight == 2.0).all() and (w8 == 2.0).all() and (wj == 2.0).all()
    local = _local(sb, camera, params, 32, 32, 2, 3)
    np.testing.assert_allclose(img, local, atol=1e-5)
    assert np.array_equal(img, local)
    bound = local.max(axis=-1, keepdims=True) / 128.0 + 1e-6
    assert (np.abs(img8 - local) <= bound).all()
    err = np.abs(np.power(np.maximum(imgj, 0) / 2, 1 / 2.2)
                 - np.power(np.clip(local / 2, 0, None), 1 / 2.2))
    assert float(np.median(err)) < 0.05


def test_malformed_peer_rejected():
    """A wrong magick drops the connection; a corrupt crc raises
    ConnectionError on the client's side."""
    server, = _servers(1)
    s = socket.create_connection(('127.0.0.1', server.port), timeout=10)
    payload = network.encode_tree({'serverID': 0, 'serverCount': 1})
    s.sendall(network._FRAME.pack(0xDEADBEEF, network.VERSION,
                                  network.OP_HELLO, len(payload), 0)
              + payload)
    s.settimeout(10)
    try:
        assert s.recv(1) == b''
    except (ConnectionResetError, ConnectionError):
        pass
    s.close()
    server.stop()
    a, b = socket.socketpair()
    try:
        good = network.encode_tree({'x': 1})
        a.sendall(network._FRAME.pack(network.MAGICK, network.VERSION,
                                      network.OP_FRAME, len(good),
                                      0x12345678) + good)
        with pytest.raises(ConnectionError):
            network._recv(b)
        a.sendall(network._FRAME.pack(network.MAGICK, network.VERSION + 1,
                                      network.OP_FRAME, 0, 0))
        with pytest.raises(ConnectionError):
            network._recv(b)
    finally:
        a.close()
        b.close()


def test_render_error_answers_op_error():
    """A render that fails answers OP_ERROR (the client raises
    ConnectionError) and the connection serves the next request."""
    server, = _servers(1)
    client = _client([server])
    client.set_scene(bs.cornell_box(with_boxes=False))
    with pytest.raises(ConnectionError, match='pixel_filter'):
        client.render(bs.cornell_camera(8, 8), pt.PTParams(max_depth=1), 8,
                      8, spp=1, pixel_filter='gauss')
    img, _ = client.render(bs.cornell_camera(8, 8), pt.PTParams(max_depth=1),
                           8, 8, spp=1)
    client.close()
    assert img.max() > 0


def test_incremental_light_update():
    """OP_UPDATE_LIGHT doubles both lights' radiance without sending the
    scene again: the direct image doubles."""
    server, = _servers(1)
    sb = bs.cornell_box(with_boxes=False)
    camera, params = bs.cornell_camera(16, 16), pt.PTParams(max_depth=1)
    client = _client([server])
    client.set_scene(sb)
    img1, _ = client.render(camera, params, 16, 16, spp=1, seed=3)
    for i in (0, 1):
        client.update_light(i, L=(np.asarray(sb.lights[i]['L'])
                                  * 2.0).tolist())
    img2, _ = client.render(camera, params, 16, 16, spp=1, seed=3)
    client.close()
    lit = img1.max(axis=-1) > 1e-3
    assert lit.any()
    np.testing.assert_allclose(img2[lit], 2.0 * img1[lit], rtol=1e-5)


def test_view_pos_recommits_billboards():
    """A billboard scene over TCP with a view_pos equals the local render
    committed at that viewpoint; another view_pos changes the image."""
    settings = ecs.RenderSettings()
    sb = SceneBuilder()
    collada.load_dae(os.path.join(SCENES, 'test_room.dae'), settings, sb)
    assert sb.has_billboards()
    sb.add_light(gl.ambient((1.0, 1.0, 1.0)))
    server, = _servers(1)
    camera = gcam.Pinhole(gcam.look_at((6.0, -1.0, 0.0), (2.0, -1.0, 0.0),
                                       (0, 1, 0)), angle=60.0, aspect=1.0)
    params = pt.PTParams(max_depth=2)
    client = _client([server])
    client.set_scene(sb)
    imgs = []
    for vp in ((6.0, -1.0, 0.0), (2.0, -1.0, 6.0)):
        img, w = client.render(camera, params, 16, 16, spp=1, seed=5,
                               view_pos=vp)
        assert (w == 1.0).all()
        local = _local(sb, camera, params, 16, 16, 1, 5,
                       view_pos=np.asarray(vp))
        np.testing.assert_allclose(img, local, atol=1e-5)
        assert np.array_equal(img, local)
        imgs.append(img)
    client.close()
    assert np.abs(imgs[0] - imgs[1]).max() > 0


def test_server_cli_entry():
    """`python -m yulio_raytracer_tpu_torch.parallel.network -port P
    -device cpu -encode rgbe8 -single-connection`: its -encode overrides
    the client's native request."""
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        port = s.getsockname()[1]
    t = threading.Thread(target=network.main, args=(
        ['-port', str(port), '-host', '127.0.0.1', '-encode', 'rgbe8',
         '-device', 'cpu', '-single-connection'],), daemon=True)
    t.start()
    for _ in range(100):
        time.sleep(0.1)
        try:
            client = network.NetworkClient([('127.0.0.1', port)],
                                           connect_timeout=2.0)
            break
        except OSError:
            continue
    else:
        raise AssertionError("the server CLI never listened")
    sb = bs.cornell_box(with_boxes=False)
    camera, params = bs.cornell_camera(16, 16), pt.PTParams(max_depth=2)
    client.set_scene(sb)
    img, weight = client.render(camera, params, 16, 16, spp=1, seed=0)
    client.close()
    t.join(timeout=30)
    assert (weight == 1.0).all() and not t.is_alive()
    local = _local(sb, camera, params, 16, 16, 1, 0)
    np.testing.assert_array_equal(
        img, network.rgbe8_decode(network.rgbe8_encode(local)))


def test_server_defaults_to_the_card():
    """A server built without a device renders on the card: without one
    it raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        network.RenderServer(0)


def test_cli_connect_mono_equals_local(tmp_path):
    """-connect over two servers writes the local CLI's file, byte for
    byte; -connect refuses the precomputed sampler."""
    servers = _servers(2)
    args = ['-c', os.path.join(SCENES, 'cornell_box.ecs'), '-size', '32',
            '32', '-spp', '2', '-gamma', '1.0']
    net, loc = str(tmp_path / 'net.ppm'), str(tmp_path / 'loc.ppm')
    assert cli.main(args + ['-connect'] + [f'127.0.0.1:{s.port}'
                                           for s in servers]
                    + ['-o', net], device='cpu') == 0
    assert cli.main(args + ['-o', loc], device='cpu') == 0
    with open(net, 'rb') as f, open(loc, 'rb') as g:
        assert f.read() == g.read()
    with pytest.raises(ValueError, match='precomputed'):
        cli.main(args + ['-renderer', 'pathtracer', '{', 'sampler', '=',
                         'precomputed', '}', '-connect', '127.0.0.1:1'],
                 device='cpu')


def test_cli_connect_stereo_equals_local(tmp_path):
    """The 12-face strip of test_stereo.ecs over two servers (each face
    at the rig's view_pos) writes the local strip's bytes."""
    args = ['-c', os.path.join(SCENES, 'test_stereo.ecs'), '-size', '8',
            '8', '-spp', '1', '-depth', '2']
    old = os.getcwd()
    os.chdir(tmp_path)
    try:
        assert cli.main(args, device='cpu') == 0
        os.rename('test_stereo_view.jpg', 'local.jpg')
        servers = _servers(2)
        assert cli.main(args + ['-connect'] + [f'127.0.0.1:{s.port}'
                                               for s in servers],
                        device='cpu') == 0
        with open('local.jpg', 'rb') as f, \
                open('test_stereo_view.jpg', 'rb') as g:
            assert f.read() == g.read()
    finally:
        os.chdir(old)
