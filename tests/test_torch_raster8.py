"""The port's 8-bit pipeline (bonnie32_tpu_torch/ops/raster8.py) on
test_raster8.py's cube cases, on the CPU: against the numpy golden model
(tests/golden/raster8_golden.py), 0 differing pixels; against the JAX
package's render_mesh8 within that file's budget max(4, pixels / 2000)
(XLA:CPU contracts FMAs).  build_atlas8 field by field against the JAX
package's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scenes
import torch_render_cases as rc
import torch_scenes as ts
from bonnie32_tpu.models import build as jbuild
from bonnie32_tpu.ops import raster8 as jraster8
from bonnie32_tpu.types import FrameBuffers as JFrameBuffers
from bonnie32_tpu.types import no_fog as jno_fog
from bonnie32_tpu_torch import types
from bonnie32_tpu_torch.config import RasterSettings, ShadingMode
from bonnie32_tpu_torch.models import build
from bonnie32_tpu_torch.ops import raster8, raster_ref
from golden import raster8_golden as g8
from jax_refs import jax_settings

torch.set_num_threads(1)

W, H = 160, 120
F32_MAX = np.float32(3.4028235e38)
FOG = (2.0, 6.0, 50.0, (40, 40, 60))
CAMPOS = np.array([-1.8, -1.5, -3.2], np.float32)
BASIS = np.asarray(build.camera_basis(0.35, 0.6), np.float32)

# test_raster8.py's cases: name -> (settings, editor alpha, fog)
CASES = {
    "default": (RasterSettings.game(), 255, None),
    "no_dither": (RasterSettings.game(dithering=False,
                                      shading=ShadingMode.NONE), 255, None),
    "painters": (RasterSettings.game(use_zbuffer=False), 255, None),
    "flat_editor_alpha": (RasterSettings.game(shading=ShadingMode.FLAT),
                          128, None),
    "fog_float": (RasterSettings.game(use_fixed_point=False), 255, FOG),
}


def make_tex_rgba(w=32, h=32, holes=True, seed=0):
    rng = np.random.default_rng(seed)
    rgba = rng.integers(0, 256, size=(h, w, 4), dtype=np.uint8)
    rgba[..., 3] = 255
    if holes:
        rgba[::5, ::3, 3] = 0    # transparent texels
    return rgba


def texset():
    return [make_tex_rgba(32, 32, holes=True, seed=0),
            make_tex_rgba(16, 16, holes=False, seed=1)]


def cube(editor_alpha):
    verts, faces = ts.cube_scene(tex_ids=(0, 1, 0, None, None, 1),
                                 vertex_colors=[(128, 128, 128)] * 6)
    for f in faces:
        f["editor_alpha"] = editor_alpha
    return verts, faces


def rgba(word):
    return rc.rgba(word)


def golden_frame(name):
    """(RGBA8 pixels (H, W, 4), z-buffer (H, W)) of the golden model."""
    settings, alpha, fog = CASES[name]
    verts, faces = cube(alpha)
    gfb = dict(pixels=np.zeros((H, W, 4), np.uint8),
               zbuffer=np.full((H, W), F32_MAX))
    gset = dict(affine_textures=settings.affine_textures,
                use_zbuffer=settings.use_zbuffer,
                shading=int(settings.shading),
                backface_cull=settings.backface_cull,
                ambient=settings.ambient, dithering=settings.dithering,
                xray_mode=False, use_fixed_point=settings.use_fixed_point)
    glights = []
    for spec in ts.DEFAULT_LIGHT_SPECS:
        spec = dict(spec)
        d = np.asarray(spec["direction"], np.float32)
        n = np.float32(np.sqrt(np.float32(
            np.float32(d[0] * d[0]) + np.float32(d[1] * d[1]))
            + np.float32(d[2] * d[2])))
        spec["direction"] = (d / n).astype(np.float32)
        glights.append(spec)
    g8.render_mesh8(gfb, verts, faces, [dict(rgba=t) for t in texset()],
                    dict(position=CAMPOS, basis=BASIS), gset, glights,
                    fog=fog)
    return gfb["pixels"], gfb["zbuffer"]


def port_frame(name, clear="harmonic"):
    settings, alpha, fog = CASES[name]
    mesh, fa = rc.torch_mesh(*cube(alpha))
    cams = types.CameraArrays(torch.from_numpy(CAMPOS)[None],
                              torch.from_numpy(BASIS)[None])
    lights = build.lights_from_list(ts.DEFAULT_LIGHT_SPECS,
                                    ambient=settings.ambient)
    fb = raster_ref.new_framebuffer(H, W, clear, device="cpu")
    out = raster8.render_mesh8(
        fb, mesh, fa, build.build_atlas8([(t, 0) for t in texset()],
                                         device="cpu"),
        cams, lights, rc.torch_fog(fog), settings)
    return out


@pytest.fixture(scope="module")
def jax_frames():
    """The JAX package's render_mesh8 of every case, computed once."""
    out = {}
    for name, (settings, alpha, fog) in CASES.items():
        mesh, fa = scenes.to_jax_scene(*cube(alpha))
        fb = JFrameBuffers(color=jnp.zeros((H, W), jnp.int32),
                           depth=jnp.full((H, W), F32_MAX))
        res = jraster8.render_mesh8(
            fb, mesh, fa, jbuild.build_atlas8([(t, 0) for t in texset()]),
            jbuild.make_camera(CAMPOS, BASIS),
            jbuild.lights_from_list(ts.DEFAULT_LIGHT_SPECS,
                                    ambient=settings.ambient),
            jno_fog() if fog is None else scenes.make_fog(*fog),
            jax_settings(settings))
        out[name] = np.asarray(res.color)
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_render_mesh8_matches_golden(name):
    """Colour: 0 differing pixels.  Depth: exact under the PS1 fixed-point
    projection, whose edge terms are small integers; the golden model
    steps its edge functions incrementally and the port evaluates them
    directly, which moves a float-projection depth by ulps."""
    out = port_frame(name)
    pix = rgba(out.color[0].numpy())
    gpix, gz = golden_frame(name)
    assert (pix[..., 3] == 255).any(), "the case draws nothing"
    diff = np.any(pix != gpix, axis=-1)
    assert int(diff.sum()) == 0, f"{int(diff.sum())} pixels differ"
    if CASES[name][0].use_fixed_point:
        ddiff = int((out.depth[0].numpy() != gz).sum())
        assert ddiff == 0, f"{ddiff} depth values differ"
    else:
        np.testing.assert_allclose(out.depth[0].numpy(), gz, rtol=1e-5)


@pytest.mark.parametrize("name", sorted(CASES))
def test_render_mesh8_matches_jax(jax_frames, name):
    out = port_frame(name)
    diff = np.any(rgba(out.color[0].numpy()) != rgba(jax_frames[name]),
                  axis=-1)
    budget = max(4, diff.size // 2000)
    assert int(diff.sum()) <= budget, int(diff.sum())


def test_render_mesh8_keeps_8bit_precision():
    """Undithered pixels keep their low bits (test_raster8.py's check)."""
    pix = rgba(port_frame("no_dither").color[0].numpy())
    lit = pix[..., 3] == 255
    assert np.any(pix[lit][:, 0] & 0x7)


def test_render_mesh8_on_inverse_z_clear_draws_nothing():
    """z < 0 never holds: on the inverse-z clear the z-buffered 8-bit
    pipeline draws no face (the JAX package's behaviour); painter's mode
    tests no depth and draws."""
    assert not bool(port_frame("default", clear="inv").color.any())
    assert bool(port_frame("painters", clear="inv").color.any())


@pytest.mark.parametrize("pads", [(None, None), (2048, 4)])
def test_build_atlas8_matches_jax(pads):
    tex = texset() + [np.full((3, 5, 4), 7, np.uint8)]
    ours = build.build_atlas8([(t, b) for t, b in zip(tex, (0, 1, 2))],
                              pad_data_to=pads[0], pad_count_to=pads[1],
                              device="cpu")
    theirs = jbuild.build_atlas8([(t, b) for t, b in zip(tex, (0, 1, 2))],
                                 pad_data_to=pads[0], pad_count_to=pads[1])
    for f in types.TextureAtlas8._fields:
        a, b = getattr(ours, f).numpy(), np.asarray(getattr(theirs, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert bool(((ours.data >> 24) == 5).any())        # ERASE texels


def test_blend8_matches_jax():
    rng = np.random.default_rng(3)
    f, b = rng.integers(0, 256, (2, 3, 600)).astype(np.int32)
    mode = np.repeat(np.arange(6, dtype=np.int32), 100)
    ours = raster8.blend8(*torch.from_numpy(f), *torch.from_numpy(b),
                          torch.from_numpy(mode))
    theirs = jraster8.blend8(*jnp.asarray(f), *jnp.asarray(b),
                             jnp.asarray(mode))
    for o, t in zip(ours, theirs):
        np.testing.assert_array_equal(o.numpy(), np.asarray(t))
