"""ECS command-stream parser: argv and `.ecs` files as one token language.

The torch package's counterpart of `yulio_raytracer_tpu/io/ecs.py`, tag
for tag.  Reproduces the reference's layered flag system (`renderer.cpp:974-1403` +
`common/lexers/`): whitespace tokens, `#` line comments
(LineCommentFilter, renderer.cpp:1432-1436), recursive `-c` includes, and
`{ key = value }` renderer sub-blocks.  Golden `.ecs` scenes from
`models/` parse verbatim.

The parser mutates a RenderSettings (the ~40 globals of renderer.cpp:
243-304) and stages scene content into a SceneBuilder.  Tags that select
what renders the frame (-devices, -connect, -display, -viewer, ...) only
set their field here.  Collada (`.dae`) scenes are not ported yet and
raise NotImplementedError.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..scene import SceneBuilder
from ..shading import materials as gmat
from ..lights import lights as glights
from ..geometry import primitives
from . import image as gimage
from . import obj as gobj

EYE_SEPARATION = 6.35 * 0.393701


@dataclass
class RenderSettings:
    """Defaults match renderer.cpp:243-304 and the pathtracer parms."""
    cam_pos: tuple = (0.0, 0.0, 0.0)
    cam_look_at: tuple = (1.0, 0.0, 0.0)
    cam_up: tuple = (0.0, 1.0, 0.0)
    fov: float = 64.0
    cam_radius: float = 0.0          # > 0 -> depth-of-field camera
    focal_distance: float = 1.0
    stereo: bool = False
    eye_separation: float = EYE_SEPARATION
    toe_in: bool = False
    zero_parallax: float = EYE_SEPARATION * 30.0
    t_max_shadow_ray: float = float('inf')
    t_max_shadow_jitter: float = 0.2
    scene_scale: float = 1.0
    watermark: bool = False
    face_culling_mode: str = 'default'
    depth: int = -1                  # -1 -> integrator default (10)
    spp: int = 1
    min_contribution: float = 0.02
    width: int = 512
    height: int = 512
    gamma: float = 1.0
    vignetting: bool = False
    framebuffer: str = 'RGB8'
    out_file: str = ''
    # last -i scene path (set by parse; names stereo outputs
    # <scene>_<camera>.jpg like renderer.cpp:717-724)
    scene_file: str = ''
    num_frames: int = 1
    jpeg_quality: int = 90
    renderer: str = 'pathtracer'
    backplate: Optional[np.ndarray] = None
    accumulate: int = 1              # -refine
    display: bool = False
    # -debug: write each cube face image to disk (renderer.cpp:657-660)
    debug: bool = False
    # -viewer [port]: interactive web viewer (glutdisplay analog) instead
    # of the headless progressive loop; 0 = off
    viewer_port: int = 0
    verbose: int = 0
    # pixel reconstruction filter: the reference defaults to b-spline
    # (integratorrenderer.cpp:45-49)
    pixel_filter: str = 'bspline'
    # sample generator: 'stateless' (the default) or 'precomputed' = the
    # reference's exact 64-sample-set sequences (sampler.cpp:85-160;
    # sampling/precomputed.py) for sample-level A/B parity renders
    sampler: str = 'stateless'
    # multi-chip pixel data parallelism (`-devices N`): 1 = single
    # device, 0 = every visible device, N = the first N devices
    devices: int = 1
    # `-connect host[:port] ...` (renderer.cpp:948-956): distributed
    # TCP render servers (parallel/network.py; port defaults to 8282)
    connect: tuple = ()
    # `-accel {default|bvh2|bvh4|bvh4mb}` (renderer.cpp -rtcore accel=;
    # sphere_motion.ecs): traversal kernel family, passed to commit()
    accel: str = 'default'
    # `--no-logging` (renderer.cpp:989-991) clears it
    log_display: bool = True


class TokenStream:
    """Whitespace tokens with '#' comments, matching the lexer stack used
    for .ecs files (common/lexers, wired renderer.cpp:1432-1436)."""

    def __init__(self, text: str):
        toks = []
        for line in text.splitlines():
            body = line.split('#', 1)[0]
            toks.extend(body.split())
        self.toks = toks
        self.pos = 0

    @classmethod
    def from_argv(cls, argv):
        ts = cls('')
        ts.toks = list(argv)
        return ts

    def peek(self) -> str:
        return self.toks[self.pos] if self.pos < len(self.toks) else ''

    def get(self) -> str:
        t = self.peek()
        self.pos += 1
        return t

    def get_float(self) -> float:
        return float(self.get())

    def get_int(self) -> int:
        return int(self.get())

    def get_vec3(self):
        return (self.get_float(), self.get_float(), self.get_float())

    def empty(self) -> bool:
        return self.pos >= len(self.toks)


def _cull_from_mode(mode: str) -> int:
    # face culling modes (ColladaLoader.cpp:601-615 / -faceCullingMode)
    from ..geometry import mesh as gmesh
    return gmesh.CULL_BACK if mode == 'forcesingle' else gmesh.CULL_NONE


def parse(tokens: TokenStream, settings: RenderSettings, sb: SceneBuilder,
          base_path: str = '.'):
    """Consume the full token stream (parseCommandLine, renderer.cpp:974)."""
    while not tokens.empty():
        tag = tokens.get()
        if not tag:
            continue

        if tag == '-c':
            fn = os.path.join(base_path, tokens.get())
            sub = TokenStream(open(fn).read())
            parse(sub, settings, sb, os.path.dirname(fn) or '.')

        elif tag == '-i':
            fn = os.path.join(base_path, tokens.get())
            settings.scene_file = fn   # output naming: <scene>_<cam>.jpg
            load_scene_file(fn, settings, sb)

        elif tag == '-trisphere':
            p = tokens.get_vec3()
            r = tokens.get_float()
            nt = tokens.get_int()
            np_ = tokens.get_int()
            mat = sb.add_material(gmat.make_material(
                'matte', {'reflectance': (1.0, 0.0, 0.0)}))
            sb.add_mesh(primitives.tessellate_sphere(p, r, nt, np_,
                                                     material=mat))

        elif tag == '-ambientlight':
            sb.add_light(glights.ambient(tokens.get_vec3()))
        elif tag == '-pointlight':
            sb.add_light(glights.point(tokens.get_vec3(), tokens.get_vec3()))
        elif tag == '-masked_pointlight':
            p = tokens.get_vec3()
            i = tokens.get_vec3()
            im = tokens.get_int()
            sm = tokens.get_int()
            sb.add_light(glights.point(p, i, illum_mask=im, shadow_mask=sm))
        elif tag in ('-directionallight', '-dirlight'):
            sb.add_light(glights.directional(tokens.get_vec3(),
                                             tokens.get_vec3()))
        elif tag == '-distantlight':
            d = tokens.get_vec3()
            l = tokens.get_vec3()
            sb.add_light(glights.distant(d, l, tokens.get_float()))
        elif tag == '-spotlight':
            p = tokens.get_vec3()
            d = tokens.get_vec3()
            i = tokens.get_vec3()
            amin = tokens.get_float()
            amax = tokens.get_float()
            sb.add_light(glights.spot(p, d, i, amin, amax))
        elif tag == '-trianglelight':
            p = np.asarray(tokens.get_vec3())
            u = np.asarray(tokens.get_vec3())
            v = np.asarray(tokens.get_vec3())
            l = tokens.get_vec3()
            sb.add_light(glights.triangle(p, p + u, p + v, l))
        elif tag == '-quadlight':
            from .builtin_scenes import add_quad_light
            p = tokens.get_vec3()
            u = tokens.get_vec3()
            v = tokens.get_vec3()
            l = tokens.get_vec3()
            add_quad_light(sb, p, u, v, l)
        elif tag == '-hdrilight':
            l = tokens.get_vec3()
            img = gimage.load(os.path.join(base_path, tokens.get()))
            sb.add_light(glights.hdri(img, l))

        elif tag == '-vp':
            settings.cam_pos = tokens.get_vec3()
        elif tag == '-vi':
            settings.cam_look_at = tokens.get_vec3()
        elif tag == '-vd':
            d = tokens.get_vec3()
            settings.cam_look_at = tuple(np.asarray(settings.cam_pos)
                                         + np.asarray(d))
        elif tag == '-vu':
            settings.cam_up = tokens.get_vec3()
        elif tag in ('-angle', '-fov'):
            settings.fov = tokens.get_float()
        elif tag == '-radius':
            settings.cam_radius = tokens.get_float()
        elif tag == '-focaldistance':
            settings.focal_distance = tokens.get_float()
        elif tag == '-stereo':
            settings.stereo = True
        elif tag == '-toeIn':
            settings.toe_in = True
        elif tag == '-waterMark':
            settings.watermark = True
        elif tag == '-eyeSeparation':
            settings.eye_separation = tokens.get_float()
        elif tag == '-zeroParallax':
            settings.zero_parallax = tokens.get_float()
        elif tag == '-size':
            settings.width = tokens.get_int()
            settings.height = tokens.get_int()
        elif tag == '-jpegQuality':
            settings.jpeg_quality = tokens.get_int()
        elif tag in ('-framebuffer', '-fb'):
            settings.framebuffer = tokens.get()
        elif tag == '-refine':
            settings.accumulate = tokens.get_int()
        elif tag == '-gamma':
            settings.gamma = tokens.get_float()
        elif tag == '-vignetting':
            settings.vignetting = bool(tokens.get_int())
        elif tag == '-depth':
            settings.depth = tokens.get_int()
        elif tag == '-tMaxShadowRay':
            settings.t_max_shadow_ray = (tokens.get_float()
                                         * settings.scene_scale)
        elif tag == '-tMaxShadowJitter':
            settings.t_max_shadow_jitter = tokens.get_float()
        elif tag == '-faceCullingMode':
            settings.face_culling_mode = tokens.get()
        elif tag == '-spp':
            settings.spp = tokens.get_int()
        elif tag == '-backplate':
            settings.backplate = gimage.load(
                os.path.join(base_path, tokens.get()))
        elif tag == '-frames':
            settings.num_frames = tokens.get_int()
        elif tag == '-o':
            settings.out_file = tokens.get()
        elif tag == '-display':
            settings.display = True
        elif tag == '-viewer':
            settings.display = True
            settings.viewer_port = (tokens.get_int()
                                    if tokens.peek().isdigit() else 8265)
        elif tag == '-renderer':
            settings.renderer = tokens.get()
            _parse_renderer_block(tokens, settings, base_path)
        elif tag == '-accel':
            # acceleration-structure selection (renderer.cpp -rtcore
            # "accel=" parsing; models/sphere_motion.ecs uses bvh4mb).
            # Embree spellings like 'bvh4.triangle4' map to the wide
            # kernel; 'default' auto-selects (bvh4 when its table fits
            # — the round-5 measured default; scene.commit docstring).
            tok = tokens.get()
            if tok.startswith('bvh4mb'):
                settings.accel = 'bvh4mb'
            elif tok.startswith('bvh4'):
                settings.accel = 'bvh4'
            elif tok == 'default':
                settings.accel = 'default'
            elif tok.startswith('bvh2'):
                settings.accel = 'bvh2'
            else:
                raise ValueError(f"unknown -accel value: {tok}")
        elif tag in ('-scene', '-builder', '-traverser', '-device'):
            tokens.get()   # accepted, no-op (one device kind)
        elif tag == '-devices':
            # multi-chip fan-out (the -connect analog): 0 = all chips
            settings.devices = tokens.get_int()
        elif tag == '-connect':
            # reference form: every following non-flag token is a server
            # address (renderer.cpp:948-956) — selects the distributed
            # TCP device (parallel/network.py NetworkClient)
            hosts = []
            while tokens.peek() and not tokens.peek().startswith('-'):
                hosts.append(tokens.get())
            if not hosts:
                raise ValueError(
                    "-connect requires at least one host[:port] token")
            settings.connect = tuple(settings.connect) + tuple(hosts)
        elif tag == '-threads':
            tokens.get()
        elif tag == '-verbose':
            settings.verbose = tokens.get_int()
        elif tag == '-debug':
            settings.debug = True      # per-face debug JPEGs in stereo
        elif tag == '--no-logging':
            settings.log_display = False   # renderer.cpp:989-991
        elif tag in ('-profiling', '-fullscreen', '-regression'):
            pass
        elif tag == '-rtcore':
            tokens.get()
        else:
            raise ValueError(f"unknown command-line tag: {tag}")


def _parse_renderer_block(tokens: TokenStream, settings: RenderSettings,
                          base_path: str):
    """`pathtracer { depth = 2 spp = 16 ... }` (renderer.cpp:425-441)."""
    if tokens.peek() != '{':
        return
    tokens.get()
    while tokens.peek() != '}':
        key = tokens.get()
        if tokens.peek() == '=':
            tokens.get()
        if key == 'depth':
            settings.depth = tokens.get_int()
        elif key == 'spp':
            settings.spp = tokens.get_int()
        elif key == 'minContribution':
            settings.min_contribution = tokens.get_float()
        elif key == 'tMaxShadowRay':
            settings.t_max_shadow_ray = (tokens.get_float()
                                         * settings.scene_scale)
        elif key == 'backplate':
            settings.backplate = gimage.load(
                os.path.join(base_path, tokens.get()))
        elif key == 'filter':
            settings.pixel_filter = tokens.get().lower().replace(
                'bsplinefilter', 'bspline').replace('boxfilter', 'box')
        elif key == 'sampler':
            v = tokens.get().lower()
            settings.sampler = ('precomputed' if v in
                                ('precomputed', 'multijittered', 'default')
                                else 'stateless')
        else:
            tokens.get()
    tokens.get()


def load_scene_file(path: str, settings: RenderSettings, sb: SceneBuilder):
    """`-i` scene dispatch by extension (loaders.cpp:68-74)."""
    ext = os.path.splitext(path)[1].lower()
    cull = _cull_from_mode(settings.face_culling_mode)
    if ext == '.obj':
        gobj.load_obj(path, sb, cull=cull)
    elif ext == '.xml':
        from . import xml_scene
        xml_scene.load_xml(path, sb)
    elif ext == '.dae':
        raise NotImplementedError(
            f"Collada scenes are not ported to the torch package yet: {path}")
    else:
        raise ValueError(f"unknown scene format: {path}")


def parse_ecs(path: str, settings: Optional[RenderSettings] = None,
              sb: Optional[SceneBuilder] = None):
    settings = settings or RenderSettings()
    sb = sb or SceneBuilder()
    ts = TokenStream(open(path).read())
    parse(ts, settings, sb, os.path.dirname(path) or '.')
    return settings, sb
