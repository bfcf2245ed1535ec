"""The configurations of tests/test_raster_parity.py for the port's
render_mesh_15 (bonnie32_tpu_torch/render.py), with their three
renderers: the numpy golden model (tests/golden/raster_golden.py) and
the port; tests/jax_refs.py renders them with the JAX package.  Shared by
tests/test_torch_render*.py and chip_smoke.py; imports no jax.

Every frame is 120x160 RGBA8 (H, W, 4) uint8, cleared to 0 with the
depth plane the rasterizer of the mode needs: F32_MAX where it takes
"harmonic" (which "fast" does under ortho), else 0.
"""

import numpy as np
import torch

import torch_scenes as ts
from golden import raster_golden as gold
from bonnie32_tpu_torch import render, types
from bonnie32_tpu_torch.config import BlendMode, RasterSettings, ShadingMode
from bonnie32_tpu_torch.models import build
from bonnie32_tpu_torch.ops import raster_ref

W, H = 160, 120
MODES = ("fast", "inv", "harmonic")
BASIS = build.camera_basis(0.35, 0.6)
CAMPOS = np.array([-1.8, -1.5, -3.2], np.float32)
# the top-down ortho camera of test_parity_ortho_projection (camera.rs:35-45)
ORTHO_BASIS = np.array([[-1, 0, 0], [0, 0, 1], [0, 1, 0]], np.float32)
ORTHO_CAMPOS = np.array([0, -10, 0], np.float32)
FOG = (2.0, 4.0, 30.0, (90, 110, 140))


def ortho_settings():
    """test_parity_ortho_projection's: game settings, float projection,
    zoom 40 about the origin."""
    from bonnie32_tpu_torch import config
    return ts.ortho_settings(config, zoom=40.0, use_fixed_point=False)


def standard_scene(**cube_kw):
    tex = [ts.checker_texture15(32, 32, with_black=True,
                                with_transparent=True),
           ts.checker_texture15(16, 16, c1=0x7C00, c2=0x03E0)]
    vertex_colors = [(128, 128, 128), (255, 64, 64), (40, 200, 90),
                     (128, 128, 128), (200, 200, 0), (90, 90, 255)]
    verts, faces = ts.cube_scene(tex_ids=(0, 1, 0, None, None, 1),
                                 vertex_colors=vertex_colors, **cube_kw)
    return verts, faces, tex


def blend_scene():
    """Two cubes with AVERAGE and ADD textures (test_parity_blend_modes)."""
    tex = [ts.checker_texture15(32, 32, with_black=True),
           ts.checker_texture15(16, 16, c1=0xFC00 | 0x8000, c2=0x83E0,
                                blend_mode=int(BlendMode.AVERAGE)),
           ts.checker_texture15(8, 8, c1=0x9E60, c2=0x8421,
                                blend_mode=int(BlendMode.ADD))]
    verts, faces = ts.cube_scene(tex_ids=(0, 1, 0, 1, None, 1))
    v2, f2 = ts.cube_scene(tex_ids=(2,) * 6, size=1.4,
                           center=(0.4, 0.2, 1.2))
    off = len(verts)
    for f in f2:
        f["v0"] += off
        f["v1"] += off
        f["v2"] += off
    return verts + v2, faces + f2, tex


# name -> (scene, settings, fog, exact): `exact` configurations (the PS1
# fixed-point projection) equal the golden model on every pixel; the
# float projection may differ on 0.5% of the pixels, ortho on 1%
# (test_raster_parity.py:208-216, 284-318: direct vs incremental edge
# functions)
CONFIGS = {
    "ps1_default": (standard_scene, RasterSettings.game(), None, True),
    "painters": (standard_scene, RasterSettings.game(use_zbuffer=False),
                 None, True),
    "no_dither_flat": (standard_scene, RasterSettings.game(
        dithering=False, shading=ShadingMode.FLAT), None, True),
    "shading_none": (standard_scene, RasterSettings.game(
        shading=ShadingMode.NONE), None, True),
    "black_opaque": (lambda: standard_scene(black_transparent=False),
                     RasterSettings.game(), None, True),
    "blend_modes": (blend_scene, RasterSettings.game(), None, True),
    "fog": (standard_scene, RasterSettings.game(), FOG, True),
    "editor_alpha_backfaces": (lambda: standard_scene(editor_alpha=140),
                               RasterSettings(backface_cull=False,
                                              backface_wireframe=False),
                               None, True),
    "xray": (standard_scene, RasterSettings.game(xray_mode=True), None,
             True),
    "float_projection": (standard_scene, RasterSettings.game(
        use_fixed_point=False), None, False),
    "backface_wireframe": (standard_scene, RasterSettings(), None, True),
    "overlay": (standard_scene, RasterSettings.game(wireframe_overlay=True),
                None, True),
    "ortho": (standard_scene, ortho_settings(), None, False),
}
GOLDEN_LIMIT = {"float_projection": 0.005, "ortho": 0.01}


def camera_of(name):
    if name == "ortho":
        return ORTHO_CAMPOS, ORTHO_BASIS
    return CAMPOS, BASIS


def light_specs_of(name):
    return [] if name == "ortho" else ts.DEFAULT_LIGHT_SPECS


def clear_mode(settings, mode):
    """The depth clear of the rasterizer `mode` takes."""
    return ("harmonic" if render.raster_mode(settings, mode) == "harmonic"
            else "inv")


def rgba(word):
    """Packed RGBA8 words (..., H, W) -> (..., H, W, 4) uint8."""
    word = np.asarray(word)
    return np.stack([(word >> s) & 0xFF for s in (0, 8, 16, 24)],
                    axis=-1).astype(np.uint8)


def golden_frame(name):
    scene, settings, fog, _ = CONFIGS[name]
    verts, faces, tex = scene()
    campos, basis = camera_of(name)
    o = settings.ortho_projection
    gsettings = dict(
        affine_textures=settings.affine_textures,
        use_zbuffer=settings.use_zbuffer, shading=int(settings.shading),
        backface_cull=settings.backface_cull, ambient=settings.ambient,
        dithering=settings.dithering, xray_mode=settings.xray_mode,
        use_fixed_point=settings.use_fixed_point,
        ortho=None if o is None else dict(zoom=o.zoom, center_x=o.center_x,
                                          center_y=o.center_y),
        backface_wireframe=settings.backface_wireframe,
        wireframe_overlay=settings.wireframe_overlay)
    glights = []
    for spec in light_specs_of(name):
        spec = dict(spec)
        d = np.asarray(spec["direction"], np.float32)
        ln = np.float32(np.sqrt(np.float32(
            np.float32(d[0] * d[0]) + np.float32(d[1] * d[1]))
            + np.float32(d[2] * d[2])))
        spec["direction"] = (d / ln).astype(np.float32)
        glights.append(spec)
    fb = gold.new_framebuffer(W, H)
    gold.render_mesh_15(fb, verts, faces,
                        [dict(pixels=np.asarray(p, np.int64), blend_mode=b)
                         for p, b in tex],
                        dict(position=campos, basis=basis), gsettings,
                        glights, fog=fog)
    return fb["pixels"]


def torch_mesh(verts, faces):
    """Vertex and face dicts -> the port's (MeshArrays, FaceArrays)."""
    mesh = build.make_mesh_arrays(
        np.array([v["pos"] for v in verts], np.float32),
        np.array([v["uv"] for v in verts], np.float32),
        np.array([v["normal"] for v in verts], np.float32),
        np.array([v.get("color", (128, 128, 128)) for v in verts],
                 np.int32),
        np.array([v.get("color_blend", 0) for v in verts], np.int32))
    fa = build.make_face_arrays(
        np.array([(f["v0"], f["v1"], f["v2"]) for f in faces], np.int32),
        np.array([-1 if f.get("tex_id") is None else f["tex_id"]
                  for f in faces], np.int32),
        np.array([f.get("black_transparent", True) for f in faces], bool),
        np.array([f.get("blend_mode", 0) for f in faces], np.int32),
        np.array([f.get("editor_alpha", 255) for f in faces], np.int32))
    return mesh, fa


def torch_fog(fog):
    if fog is None:
        return types.no_fog(device="cpu")
    start, falloff, cull, color = fog
    return types.Fog(enabled=torch.tensor(True),
                     start=torch.tensor(start, dtype=torch.float32),
                     falloff=torch.tensor(falloff, dtype=torch.float32),
                     cull_distance=torch.tensor(cull, dtype=torch.float32),
                     color=torch.tensor(color, dtype=torch.int32))


def port_inputs(name, device="cpu"):
    """(mesh, faces, atlas, cams (1,), lights, fog, settings) of a
    configuration, on `device`."""
    scene, settings, fog, _ = CONFIGS[name]
    verts, faces, tex = scene()
    mesh, fa = torch_mesh(verts, faces)
    campos, basis = camera_of(name)
    cams = types.CameraArrays(torch.from_numpy(campos)[None],
                              torch.from_numpy(basis)[None])
    lights = build.lights_from_list(light_specs_of(name),
                                    ambient=settings.ambient)
    tree = (mesh, fa, build.build_atlas(tex), cams, lights, torch_fog(fog))
    return tuple(types.to_device(x, device) for x in tree) + (settings,)


def port_frame(name, mode, device="cpu", height=H, width=W):
    """The port's render_mesh_15 of a configuration: (height, width) i32
    words."""
    mesh, fa, atlas, cams, lights, fog, settings = port_inputs(name, device)
    fb = raster_ref.new_framebuffer(height, width,
                                    clear_mode(settings, mode),
                                    device=device)
    out = render.render_mesh_15(fb, mesh, fa, atlas, cams, lights, fog,
                                settings, depth_mode=mode)
    return out.color[0].cpu().numpy()


def seam_budget(npixels):
    """test_raster_parity.py's: XLA:CPU contracts a*b+c into FMAs, which
    can flip near-ties on seams."""
    return max(4, npixels // 2000)
