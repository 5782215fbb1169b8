"""The torch port's lights, distributions and miss path held against the JAX
package on the same numpy inputs: `sample` of every light kind, `le_env`,
the scene bounds, the 1D/2D distributions, the analytic render checks of
tests/test_lights_render.py, `trace` under each kind, a backplate render,
and trace_compacted under the environment lights.

Tolerances: floats at rtol 1e-5 (atol 1e-6 where values pass through
zero); integer texel indices, bucket indices and the pdf > 0 / radiance
masks equal.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from yulio_raytracer_tpu.lights import lights as jgl
from yulio_raytracer_tpu.sampling import distribution as jdist
from yulio_raytracer_tpu.integrator import pathtracer as jpt
from yulio_raytracer_tpu import renderer as jrenderer
from yulio_raytracer_tpu.film import accum as jaccum
from yulio_raytracer_tpu.scene import SceneBuilder as JSceneBuilder
from yulio_raytracer_tpu.geometry.mesh import HostMesh as JHostMesh
from yulio_raytracer_tpu.geometry import primitives as jprim
from yulio_raytracer_tpu.shading import materials as jmat
from yulio_raytracer_tpu.cameras import cameras as jcam

from yulio_raytracer_tpu_torch.lights import lights as gl
from yulio_raytracer_tpu_torch.sampling import distribution as dist
from yulio_raytracer_tpu_torch.integrator import pathtracer as pt
from yulio_raytracer_tpu_torch import renderer
from yulio_raytracer_tpu_torch import scene as tscene
from yulio_raytracer_tpu_torch.film import accum
from yulio_raytracer_tpu_torch.scene import SceneBuilder
from yulio_raytracer_tpu_torch.geometry.mesh import HostMesh
from yulio_raytracer_tpu_torch.geometry import primitives
from yulio_raytracer_tpu_torch.shading import materials as gmat
from yulio_raytracer_tpu_torch.cameras import cameras as cam

torch.set_num_threads(2)
RTOL, ATOL = 1e-5, 1e-6
R = 4096


def _t(x):
    return torch.as_tensor(np.array(x))


def _psnr(a, b):
    mse = ((a - b) ** 2).mean()
    return 10 * np.log10(max(a.max(), 1e-9) ** 2 / max(mse, 1e-20))


def _env_map(h=16, w=32, seed=3):
    """A random map with a zero row and zero texels (a run of them ends
    a row, so the search meets ties over zero weight)."""
    img = np.random.RandomState(seed).rand(h, w, 3).astype(np.float32) * 3
    img[h // 4] = 0.0
    img[h // 2, w // 8:w // 4 + 1] = 0.0
    img[h - 2, w - 3:] = 0.0
    return img


def _l2w():
    """A rotation about an oblique axis with a translation, (4, 3)."""
    a = np.deg2rad(35.0)
    u = np.asarray([1.0, 2.0, 0.5]) / np.linalg.norm([1.0, 2.0, 0.5])
    k = np.asarray([[0, -u[2], u[1]], [u[2], 0, -u[0]], [-u[1], u[0], 0]])
    rot = np.eye(3) + np.sin(a) * k + (1 - np.cos(a)) * k @ k
    return np.concatenate([rot.T, [[3.0, -1.0, 2.0]]]).astype(np.float32)


def _lights(mod):
    """One light of every kind, built by one package's builders."""
    return {
        'ambient': mod.set_scene_bounds(mod.ambient((0.8, 0.9, 1.1)),
                                        np.float32([-3, -1, -2]),
                                        np.float32([4, 5, 3])),
        'point': mod.point((0.5, 4.0, -1.0), (3.0, 2.0, 1.0)),
        'spot': mod.spot((1.0, 5.0, 0.5), (0.2, -1.0, 0.1), (40.0, 30.0, 20.0),
                         30.0, 70.0),
        'spot_hard': mod.spot((1.0, 5.0, 0.5), (0.0, -1.0, 0.0),
                              (4.0, 3.0, 2.0), 60.0, 60.0),
        'directional': mod.directional((-1.0, -2.0, 0.5), (2.0, 2.5, 3.0)),
        'distant': mod.distant((0.3, -1.0, 0.2), (5.0, 4.0, 3.0), 7.5),
        'triangle': mod.triangle((-1, 3, -1), (2, 3, 0), (0, 3.5, 2),
                                 (6.0, 5.0, 4.0)),
        'hdri': mod.hdri(_env_map(), (1.5, 1.0, 0.5), _l2w()),
    }


def _to_dev(light):
    """A port light's arrays as tensors (what commit does)."""
    return {k: (v if isinstance(v, (str, int)) or k == 'dist' else _t(v))
            for k, v in light.items()}


def _to_jax(light):
    return {k: (v if isinstance(v, (str, int)) or k == 'dist'
                else jnp.asarray(v)) for k, v in light.items()}


def _shade_points(seed=0):
    rs = np.random.RandomState(seed)
    p = rs.uniform(-2, 2, (R, 3)).astype(np.float32)
    n = rs.randn(R, 3)
    n = (n / np.linalg.norm(n, axis=-1, keepdims=True)).astype(np.float32)
    u2 = rs.rand(R, 2).astype(np.float32)
    return p, n, u2


@pytest.mark.parametrize('kind', sorted(_lights(gl)))
def test_sample_matches_jax(kind):
    """sample() of one light of each kind at random shade points, normals
    and samples: Le, wi, pdf and tmax at the stated tolerance, the
    candidate masks equal; for the HDRI the texel indices equal."""
    light, jlight = _to_dev(_lights(gl)[kind]), _to_jax(_lights(jgl)[kind])
    p, n, u2 = _shade_points()
    got = gl.sample(light, _t(p), _t(n), _t(u2))
    ref = jgl.sample(jlight, jnp.asarray(p), jnp.asarray(n), jnp.asarray(u2))
    for name, g, r in zip(('Le', 'wi', 'pdf', 'tmax'), got, ref):
        r = np.broadcast_to(np.asarray(r), g.shape)
        assert g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), r, rtol=RTOL, atol=ATOL,
                                   err_msg=name)
    np.testing.assert_array_equal(got[2].numpy() > 0,
                                  np.broadcast_to(np.asarray(ref[2]) > 0,
                                                  (R,)))
    np.testing.assert_array_equal(torch.any(got[0] > 0, dim=-1).numpy(),
                                  np.asarray(jnp.any(ref[0] > 0, axis=-1)))
    if kind == 'hdri':
        xy, _ = dist.sample_2d(light['dist'], _t(u2))
        jxy, _ = jdist.sample_2d(jlight['dist'], jnp.asarray(u2))
        np.testing.assert_array_equal(xy.to(torch.int64).numpy(),
                                      np.asarray(jxy).astype(np.int64))
        # the radiance is a texel of the map times L: equal
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    if kind == 'ambient':
        assert np.isfinite(got[3].numpy()).all()


@pytest.mark.parametrize('kind', ['ambient', 'point', 'spot', 'directional',
                                  'distant', 'triangle'])
def test_stacked_sample_matches_each_light(kind):
    """Three lights of a kind stacked to (3, 1, ...) and sampled in one
    call, as the bounce's groups do, equal each light sampled alone."""
    mods = [_lights(gl)[kind]]
    for s in (1.5, 0.5):
        l2 = dict(mods[0])
        for k, v in l2.items():
            if not isinstance(v, (str, int)) and k in ('L', 'I', 'E', 'P',
                                                        'v0'):
                l2[k] = np.asarray(v * s, np.float32)
        mods.append(l2)
    lights = [_to_dev(l) for l in mods]
    idxs, stacked, _ = pt._light_groups(lights)[0]
    assert idxs == [0, 1, 2]
    p, n, u2 = _shade_points(1)
    u3 = np.stack([u2, u2[::-1], u2[:, ::-1]])
    got = gl.sample(stacked, _t(p), _t(n), _t(u3))
    for i, l in enumerate(lights):
        one = gl.sample(l, _t(p), _t(n), _t(u3[i]))
        for g, r in zip(got, one):
            np.testing.assert_allclose(g[i].numpy(),
                                       r.expand(g[i].shape).numpy(),
                                       rtol=RTOL, atol=ATOL)


def test_light_groups_follow_the_reference_order():
    """Groups keyed by kind, an HDRI by (kind, width, height), in order of
    first appearance; each HDRI sampled alone with its own index."""
    big = gl.hdri(_env_map(8, 16))
    small = gl.hdri(_env_map(4, 8))
    lights = [_to_dev(l) for l in (
        gl.point((0, 1, 0), (1, 1, 1)), big, gl.ambient((1, 1, 1)), small,
        gl.point((0, 2, 0), (1, 1, 1)), gl.hdri(_env_map(8, 16)))]
    groups = pt._light_groups(lights)
    assert [g[0] for g in groups] == [[0, 4], [1], [5], [2], [3]]
    assert groups[1][1] is lights[1] and groups[2][1] is lights[5]


@pytest.mark.parametrize('kind', ['ambient', 'hdri', 'hdri_identity'])
def test_le_env_matches_jax(kind):
    """le_env over random directions and directions that land in the
    map's last column (the x wrap) and next to its poles, at rtol 1e-4
    (atol 1e-5): the bilinear weights u w - x carry the ulps of arccos and
    arctan2 times the map's width."""
    if kind == 'hdri_identity':
        light, jlight = gl.hdri(_env_map(7, 9)), jgl.hdri(_env_map(7, 9))
    else:
        light, jlight = _lights(gl)[kind], _lights(jgl)[kind]
    light, jlight = _to_dev(light), _to_jax(jlight)
    rs = np.random.RandomState(4)
    wo = rs.randn(R, 3)
    # phi just above 0 and just below 2 pi: u = 1 - phi / 2 pi near 1
    # and 0, the last and first columns, in the light's local frame
    phi = np.concatenate([rs.uniform(0, 0.05, 64), rs.uniform(6.25, 6.283,
                                                              64)])
    th = rs.uniform(0.1, 3.0, 128)
    local = -np.stack([-np.sin(th) * np.cos(phi), np.cos(th),
                       -np.sin(th) * np.sin(phi)], -1)
    l2w = np.asarray(light.get('local2world', np.eye(4, 3)), np.float64)
    wo[:128] = local @ l2w[:3]
    # near the poles (at a pole phi is atan2 of signed zeros, whose signs
    # the reference's own einsum sets by batch size)
    wo[128:132] = [[1e-3, -1, 0], [0, 1, 1e-3], [-1e-3, 1, 0], [0, -1, -1e-3]]
    wo = (wo / np.linalg.norm(wo, axis=-1, keepdims=True)).astype(np.float32)
    got = gl.le_env(light, _t(wo))
    ref = jgl.le_env(jlight, jnp.asarray(wo))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-5)
    if kind != 'ambient':
        with pytest.raises(ValueError):
            gl.le_env(_to_dev(_lights(gl)['point']), _t(wo))


def test_set_scene_bounds_matches_jax():
    """The ambient light's bounding sphere (radius x 1.5, at least f32
    eps); other kinds come back as they were."""
    for lo, hi in (([-3, -1, -2], [4, 5, 3]), ([1, 1, 1], [1, 1, 1])):
        lo, hi = np.float32(lo), np.float32(hi)
        got = gl.set_scene_bounds(gl.ambient((1, 1, 1)), lo, hi)
        ref = jgl.set_scene_bounds(jgl.ambient((1, 1, 1)), lo, hi)
        for k in ('bsphere_center', 'bsphere_radius'):
            assert np.asarray(got[k]).dtype == np.float32
            np.testing.assert_array_equal(got[k], ref[k])
    p = gl.point((0, 1, 0), (1, 1, 1))
    assert gl.set_scene_bounds(p, lo, hi) is p


def test_distribution_1d_matches_jax():
    """build_1d tables equal; sample_1d's bucket index equal and its
    position and pdf at the stated tolerance, over zero-weight runs."""
    f = np.float64([0, 0, 2.0, 0, 1.0, 0, 0, 3.5, 0, 0])
    d, jd = dist.build_1d(f), jdist.build_1d(f)
    for a, b in zip(d, jd):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    u = np.random.RandomState(5).rand(R).astype(np.float32)
    u[:len(d.cdf)] = d.cdf.numpy()          # u on every CDF entry
    u[-1] = 0.0
    x, pdf, idx = dist.sample_1d(d, _t(u))
    jx, jpdf, jidx = jdist.sample_1d(jd, jnp.asarray(u))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=RTOL)
    np.testing.assert_array_equal(pdf.numpy(), np.asarray(jpdf))
    np.testing.assert_array_equal(
        dist.pdf_1d(d, _t(u)).numpy(), np.asarray(jdist.pdf_1d(jd, u)))


@pytest.mark.parametrize('shape', [(16, 32), (5, 1), (3, 64)])
def test_distribution_2d_matches_jax(shape):
    """build_2d tables equal; sample_2d's integer (x, y) equal to the
    reference's row count (the binary search) on a map with zero rows and
    zero texels, positions and pdfs at the stated tolerance."""
    h, w = shape
    rs = np.random.RandomState(6)
    f = rs.rand(h, w) * (rs.rand(h, w) < 0.6)
    f[h // 2] = 0.0
    d, jd = dist.build_2d(f), jdist.build_2d(f)
    for a, b in zip(d, jd):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    uv = rs.rand(R, 2).astype(np.float32)
    # samples on CDF entries: ties, and runs of equal entries
    yi = rs.randint(0, h, 512)
    xi = rs.randint(0, w + 1, 512)
    uv[:512, 0] = d.cond_cdf.numpy()[yi, xi]
    uv[512:512 + h + 1, 1] = d.marg_cdf.numpy()
    uv[-1] = 0.0
    xy, pdf = dist.sample_2d(d, _t(uv))
    jxy, jpdf = jdist.sample_2d(jd, jnp.asarray(uv))
    np.testing.assert_array_equal(xy.to(torch.int64).numpy(),
                                  np.asarray(jxy).astype(np.int64))
    np.testing.assert_allclose(xy.numpy(), np.asarray(jxy), rtol=RTOL)
    np.testing.assert_allclose(pdf.numpy(), np.asarray(jpdf), rtol=RTOL)
    np.testing.assert_array_equal(
        dist.pdf_2d(d, _t(uv)).numpy(), np.asarray(jdist.pdf_2d(jd, uv)))


def test_row_search_counts_like_the_reference():
    """The binary search gives count(row <= u) for every row and u,
    including u below, on and above every entry."""
    rows = np.float32([[0, 0, 0, 0.25, 0.25, 0.5, 1, 1, 1],
                       [0, 0, 0, 0, 0, 0, 0, 0, 1],
                       [0, 0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1]])
    us = np.unique(np.concatenate([rows.ravel(), rows.ravel() + 1e-3,
                                   rows.ravel() - 1e-3, [2.0, -1.0]]))
    yi = np.repeat(np.arange(3), len(us))
    u = np.tile(us, 3).astype(np.float32)
    got = dist.row_search(_t(rows), _t(yi), _t(u))
    np.testing.assert_array_equal(got.numpy(),
                                  (rows[yi] <= u[:, None]).sum(-1))


# ---------------------------------------------------------------- renders

def _floor_scene(sb, hm, mat, light, albedo=0.5, **commit):
    """tests/test_lights_render.py's floor under one light, built by one
    package's SceneBuilder and HostMesh."""
    sb.add_material(mat.make_material('matte', {'reflectance': albedo}))
    pos = np.asarray([[-100, 0, -100], [100, 0, -100], [100, 0, 100],
                      [-100, 0, 100]], np.float32)
    tri = np.asarray([[0, 2, 1], [0, 3, 2]], np.int32)
    sb.add_mesh(hm(pos, tri,
                   np.tile([[0., 1., 0.]], (4, 1)).astype(np.float32)))
    sb.add_light(light)
    return sb.commit(**commit)


def _port_floor(light, **commit):
    return _floor_scene(SceneBuilder(), HostMesh, gmat, light,
                        device='cpu', **commit)


def _points(n=256):
    rs = np.random.RandomState(0)
    org = np.zeros((n, 3), np.float32)
    org[:, 0] = rs.uniform(-2, 2, n)
    org[:, 2] = rs.uniform(-2, 2, n)
    org[:, 1] = 5.0
    d = np.tile([[0.0, -1.0, 0.0]], (n, 1)).astype(np.float32)
    return _t(org), _t(d)


def _ids(n):
    return torch.arange(n), torch.zeros(n, dtype=torch.int64)


def test_directional_light_analytic():
    """L = E rho / pi cos(theta) for a directional light."""
    scene = _port_floor(gl.directional(np.asarray([-1.0, -1.0, 0.0]),
                                       (2.0, 2.0, 2.0)))
    org, d = _points()
    L, _ = pt.trace(scene, pt.PTParams(max_depth=2), org, d, 0, *_ids(256))
    np.testing.assert_allclose(L.numpy()[:, 0],
                               2.0 * 0.5 / np.pi / np.sqrt(2.0), rtol=1e-3)


def test_spot_light_cone():
    """Inside the inner cone the point-light falloff; outside, zero."""
    scene = _port_floor(gl.spot((0, 4, 0), (0, -1, 0), (40.0,) * 3, 20.0,
                                30.0))
    org = _t(np.float32([[0.0, 1.0, 0.0], [10.0, 1.0, 0.0]]))
    d = _t(np.float32([[0.0, -1.0, 0.0]] * 2))
    L, _ = pt.trace(scene, pt.PTParams(max_depth=2), org, d, 0, *_ids(2))
    np.testing.assert_allclose(L[0, 0].item(), 40.0 * 0.5 / np.pi / 16.0,
                               rtol=1e-3)
    assert L[1, 0].item() == 0.0


def test_distant_light_soft():
    """A distant light of half-angle 5 degrees gives about the energy of
    a directional light of the same integrated radiance."""
    scene = _port_floor(gl.distant((0, -1, 0), (5.0,) * 3, 5.0))
    org, d = _points(1024)
    L, _ = pt.trace(scene, pt.PTParams(max_depth=2), org, d, 0, *_ids(1024))
    omega = 2 * np.pi * (1 - np.cos(np.deg2rad(5.0)))
    np.testing.assert_allclose(L[:, 0].mean().item(),
                               5.0 * omega * 0.5 / np.pi, rtol=0.05)


def test_hdri_light_render():
    """A map bright in its upper half: the floor sees the bright
    hemisphere only, and escaped rays read the map."""
    img = np.zeros((16, 32, 3), np.float32)
    img[:8] = 2.0
    scene = _port_floor(gl.hdri(img))
    org, d = _points(2048)
    L, _ = pt.trace(scene, pt.PTParams(max_depth=2), org, d, 0, *_ids(2048))
    np.testing.assert_allclose(L[:, 0].mean().item(), 1.0, rtol=0.1)
    L2, _ = pt.trace(scene, pt.PTParams(max_depth=2), org, -d, 0,
                     *_ids(2048))
    np.testing.assert_allclose(L2.numpy()[:, 0], 2.0, atol=1e-4)


def test_many_lights_dim_layout():
    """Eight point lights widen the RNG dims; the render is finite,
    lit and deterministic."""
    sb = SceneBuilder()
    m = sb.add_material(gmat.make_material('matte', {'reflectance': 0.5}))
    pos = np.asarray([[-100, 0, -100], [100, 0, -100], [100, 0, 100],
                      [-100, 0, 100]], np.float32)
    sb.add_mesh(HostMesh(pos, np.asarray([[0, 2, 1], [0, 3, 2]], np.int32),
                         np.tile([[0., 1., 0.]], (4, 1)).astype(np.float32),
                         material=m))
    for i in range(8):
        sb.add_light(gl.point((np.cos(i), 3.0, np.sin(i)), (2.0, 2.0, 2.0)))
    scene = sb.commit(device='cpu')
    assert pt._dim_layout(8) == (3 + 8, 3 + 8 + 8)
    org, d = _points(128)
    params = pt.PTParams(max_depth=2, t_max_shadow_ray=50.0)
    rgb, _ = pt.trace(scene, params, org, d, 1, *_ids(128))
    rgb2, _ = pt.trace(scene, params, org, d, 1, *_ids(128))
    assert np.isfinite(rgb.numpy()).all() and rgb.max().item() > 0.0
    assert torch.equal(rgb, rgb2)


def _carry(js):
    """A committed JAX scene as from_numpy_scene takes it (the HDRI's
    distribution a tuple of numpy tables)."""
    def np_(d):
        return {k: np_(v) if isinstance(v, dict) else np.asarray(v)
                for k, v in (d or {}).items()}
    lights = [{k: (v if isinstance(v, (str, int, float)) else
                   tuple(np.asarray(x) for x in v) if k == 'dist' else
                   np.asarray(v)) for k, v in l.items()} for l in js.lights]
    return dict(geom=np_(js.geom), packet=np_(js.packet),
                materials=np_(js.materials), textures=np_(js.textures),
                lights=lights, leaf_size=js.leaf_size, bbox_lo=js.bbox_lo,
                bbox_hi=js.bbox_hi, num_triangles=js.num_triangles,
                lobe_types=js.lobe_types, accel=js.accel, device='cpu')


@pytest.mark.parametrize('kind', sorted(_lights(gl)))
def test_trace_matches_jax_per_light(kind):
    """trace on the floor scene under one light of each kind against the
    JAX package's trace: depth 3, 512 rays, the same keys; per-ray
    radiance at rtol 1e-4 (atol 1e-5) and equal ray counts.  The JAX
    commit carried by from_numpy_scene traces the same.  Under the
    triangle light, paths that hit the light's own surface sample the
    light in its plane, where the sign of d . Ng (whether the sample is a
    shadow candidate, with no radiance either way) is rounding: there the
    counts agree to 0.5%."""
    scene = _port_floor(_lights(gl)[kind])
    js = _floor_scene(JSceneBuilder(), JHostMesh, jmat, _lights(jgl)[kind])
    n = 512
    rs = np.random.RandomState(7)
    org = np.zeros((n, 3), np.float32)
    org[:, [0, 2]] = rs.uniform(-3, 3, (n, 2))
    org[:, 1] = 2.0
    d = rs.randn(n, 3)
    d[:, 1] = -np.abs(d[:, 1]) * (rs.rand(n) < 0.8) + 0.1
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    pid = np.arange(n, dtype=np.uint32) * 7919
    sid = np.full(n, 3, np.uint32)
    params = dict(max_depth=3)
    ref, jn = jpt.trace(js, jpt.PTParams(**params), jnp.asarray(org),
                        jnp.asarray(d), 9, jnp.asarray(pid), jnp.asarray(sid))
    for sc in (scene, tscene.from_numpy_scene(**_carry(js))):
        got, num = pt.trace(sc, pt.PTParams(**params), _t(org), _t(d), 9,
                            _t(pid.astype(np.int64)),
                            _t(sid.astype(np.int64)))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                                   atol=1e-5)
        if kind == 'triangle':
            assert abs(float(num) - float(jn)) <= 0.005 * float(jn)
        else:
            assert float(num) == float(jn)
    assert [l['kind'] for l in scene.env_lights] == (
        [kind] if kind in ('ambient', 'hdri') else [])


def _ball_scene(sb, hm, mat, prim, lights_mod, env):
    """A reduced sphere scene: a matte ball over a floor under an
    environment light, built by one package."""
    sb.add_material(mat.make_material('matte', {'reflectance': 0.7}))
    ball = sb.add_material(mat.make_material('matte',
                                             {'reflectance': (0.9, 0.4, 0.2)}))
    pos = np.asarray([[-400, 0, -400], [400, 0, -400], [400, 0, 400],
                      [-400, 0, 400]], np.float32)
    sb.add_mesh(hm(pos, np.asarray([[0, 1, 2], [2, 3, 0]], np.int32),
                   np.tile([[0., 1., 0.]], (4, 1)).astype(np.float32)))
    sb.add_mesh(prim.tessellate_sphere((0, 100, 0), 100, 10, 12,
                                       material=ball))
    sb.add_light(env(lights_mod))
    return sb


def _ball_camera(mod, w, h):
    l2w = mod.look_at((-300.0, 150.0, 200.0), (0.0, 100.0, 0.0),
                      (0.0, 1.0, 0.0))
    return mod.Pinhole(l2w, angle=70.0, aspect=w / h)


ENVS = {'ambient': lambda m: m.ambient((0.9, 1.0, 1.1)),
        'hdri': lambda m: m.hdri(_env_map(8, 16), (1.2, 1.0, 0.8))}


@pytest.mark.parametrize('env', sorted(ENVS))
def test_backplate_render_matches_jax(env):
    """render_frame(backplate=) of the reduced ball scene at 24 x 16, 2
    spp, depth 3, against the JAX package's: the unbent escaped rays read
    the backplate, the others the environment light; >= 60 dB and equal
    ray counts."""
    w, h = 24, 16
    bp = np.random.RandomState(8).rand(9, 13, 3).astype(np.float32)
    sc = _ball_scene(SceneBuilder(), HostMesh, gmat, primitives, gl,
                     ENVS[env]).commit(device='cpu')
    js = _ball_scene(JSceneBuilder(), JHostMesh, jmat, jprim, jgl,
                     ENVS[env]).commit()
    film, stats = renderer.render_frame(
        sc, _ball_camera(cam, w, h), pt.PTParams(max_depth=3), w, h, spp=2,
        seed=42, backplate=bp)
    jfilm, jstats = jrenderer.render_frame(
        js, _ball_camera(jcam, w, h), jpt.PTParams(max_depth=3), w, h,
        spp=2, seed=42, backplate=jnp.asarray(bp))
    img, ref = accum.resolve(film).numpy(), np.asarray(jaccum.resolve(jfilm))
    assert _psnr(img, ref) >= 60.0
    assert stats.num_rays == jstats.num_rays
    plain, _ = renderer.render_frame(
        sc, _ball_camera(cam, w, h), pt.PTParams(max_depth=3), w, h, spp=2,
        seed=42)
    # the sky pixels (top row) see the backplate, not the environment
    assert not np.allclose(accum.resolve(plain).numpy()[0], img[0])


@pytest.mark.parametrize('env', sorted(ENVS))
def test_trace_compacted_matches_trace_env(env):
    """trace_compacted is bit-equal to trace per ray under an environment
    light, with and without a backplate, at depth 8 (the roulette from
    bounce 4 empties lanes)."""
    w, h = 12, 10
    sc = _ball_scene(SceneBuilder(), HostMesh, gmat, primitives, gl,
                     ENVS[env]).commit(device='cpu', force_bvh=True)
    assert sc.accel == 'bvh4'
    pid = torch.arange(w * h).repeat(4)
    sid = torch.arange(4).repeat_interleave(w * h)
    from yulio_raytracer_tpu_torch.sampling import patterns
    org, dirn, tm, uv = renderer._gen_rays(
        sc, _ball_camera(cam, w, h), w, h, patterns.grid_scalars(4), pid,
        sid, 5)
    bp = _t(np.random.RandomState(9).rand(5, 7, 3).astype(np.float32))
    params = pt.PTParams(max_depth=8)
    for plate in (None, bp):
        ref, nref = pt.trace(sc, params, org, dirn, 5, pid, sid, tm, uv,
                             plate)
        stats = []
        got, n = pt.trace_compacted(sc, params, org, dirn, 5, pid, sid, tm,
                                    stats, uv, plate)
        assert torch.equal(got, ref) and float(n) == float(nref)
        assert min(s['live'] for s in stats) < w * h * 4
    with pytest.raises(ValueError):
        pt.trace(sc, params, org, dirn, 5, pid, sid, backplate=bp)
