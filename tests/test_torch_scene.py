"""Scene compile, collision compile, surfaces and prep: the port vs the
JAX package on the same level (tests/torch_scenes.py) and cameras.

Tolerances: compiled tables are exact (same host numpy, same f32 ops);
surfaces and prep from the same cameras have ints and bools exact and
floats to rtol 1e-6, because XLA:CPU contracts a*b+c into FMAs in the
JAX build_surfaces_flat while torch never contracts.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_scenes as ts
from bonnie32_tpu.config import RasterSettings, ShadingMode
from bonnie32_tpu.game import collision as jcol
from bonnie32_tpu.models import build as jbuild
from bonnie32_tpu.models import level as JL
from bonnie32_tpu.models import scene_flat as jsf
from bonnie32_tpu.ops import raster_batch as jrb
from bonnie32_tpu_torch import interop
from bonnie32_tpu_torch import rollout as trollout
from bonnie32_tpu_torch.models import level as TL
from bonnie32_tpu_torch.game import collision as tcol
from bonnie32_tpu_torch.models import scene as tscene
from bonnie32_tpu_torch.models import scene_flat as tsf
from bonnie32_tpu_torch.ops import raster_batch as trb
from bonnie32_tpu_torch.ops import raster_ref as traster_ref
from bonnie32_tpu_torch.ops import skybox as tsky
from bonnie32_tpu_torch.types import Surfaces

H, W = 48, 64
_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731


LEVELS = {"cave": (ts.cave_size_level, 328), "two_room": (ts.two_room_level,
                                                        424)}
# camera poses (position, pitch, yaw); the two-room level adds views in
# its fogged room and one from the first room whose fog culls room 1
POSES = {
    "cave": [((512.0, 2000.0, -300.0), 0.25, 0.6),
             ((4096.0, 2400.0, 1500.0), 0.45, 0.2),
             ((6000.0, 1200.0, 6500.0), 0.1, 3.6)],
    "two_room": [((2048.0, 1500.0, 10500.0), 0.15, 0.1),
                 ((3600.0, 2500.0, 14000.0), 0.4, 3.9),
                 ((4096.0, 2000.0, 1000.0), 0.0, 0.0)],
}


@pytest.fixture(scope="module", params=sorted(LEVELS))
def scenes(request):
    build_level, _ = LEVELS[request.param]
    jlevel = build_level(JL)
    tlevel = build_level(TL)
    jflat, jstatic = jsf.compile_level_flat(jlevel, ts.textures(),
                                            ts.resolver)
    tflat, tstatic = tsf.compile_level_flat(tlevel, ts.textures(),
                                            ts.resolver, device="cpu")
    return (jlevel, tlevel, _np(jflat), jstatic, tflat, tstatic,
            request.param)


@pytest.fixture(scope="module")
def surfaces_and_prep(scenes):
    """JAX surfaces + prep from three cameras, once per level."""
    jlevel, _, _, jstatic, _, _, name = scenes
    jflat, _ = jsf.compile_level_flat(jlevel, ts.textures(), ts.resolver)
    cams = [jbuild.make_camera(np.asarray(p, np.float32),
                               jbuild.camera_basis(pi, ya))
            for p, pi, ya in POSES[name]]
    cams = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *cams)
    out = {}
    for sname, settings in (("game", RasterSettings.game()),
                            ("flat_float", RasterSettings.game(
                                shading=ShadingMode.FLAT,
                                use_fixed_point=False))):
        surf = jax.vmap(lambda c: jsf.build_surfaces_flat(
            jflat, c, settings, W, H))(cams)
        prep = jax.vmap(lambda s: jrb.prep_instance(
            s, jflat.atlas, settings, W, H, jstatic.t_pad,
            group_id=jflat.f_group))(surf)
        out[sname] = (settings, _np(surf), _np(prep))
    return _np(cams), out


def _field(tree, path):
    for p in path.split("."):
        tree = getattr(tree, p)
    return np.asarray(tree.numpy() if isinstance(tree, torch.Tensor)
                      else tree)


_FLAT_FIELDS = ([f"mesh.{f}" for f in ("pos", "uv", "normal", "color",
                                       "color_blend")]
                + [f"faces.{f}" for f in tsf.FaceArrays._fields]
                + [f"fog.{f}" for f in tsf.FogFaces._fields]
                + ["ambient"]
                + [f"lights.{f}" for f in tsf.Lights._fields]
                + [f"atlas.{f}" for f in tsf.TextureAtlas._fields]
                + list(tsf.FlatScene._fields[6:]))


@pytest.mark.parametrize("path", _FLAT_FIELDS)
def test_compile_level_flat_matches_jax(scenes, path):
    _, _, jflat, _, tflat, _, _ = scenes
    ours, theirs = _field(tflat, path), _field(jflat, path)
    assert ours.dtype == theirs.dtype, (ours.dtype, theirs.dtype)
    np.testing.assert_array_equal(ours, theirs)
    if path == "faces.key_possible":
        assert ours.any() and not ours.all()


def test_flat_static_and_interop_roundtrip(scenes):
    _, _, jflat, jstatic, tflat, tstatic, name = scenes
    for f in dataclasses.fields(tstatic):
        assert getattr(tstatic, f.name) == getattr(jstatic, f.name), f.name
    assert tstatic.n_faces == LEVELS[name][1]
    carried = interop.flat_scene(jflat)
    for path in _FLAT_FIELDS:
        np.testing.assert_array_equal(_field(carried, path),
                                      _field(tflat, path))


@pytest.mark.parametrize("field", list(tcol.CollisionGrid._fields)
                         + ["player_params"])
def test_compile_collision_matches_jax(scenes, field):
    jlevel, tlevel = scenes[0], scenes[1]
    if field == "player_params":
        ours = tcol.player_params(tlevel, device="cpu")
        theirs = interop.player_params(_np(jcol.player_params(jlevel)))
        for f in ours._fields:
            assert float(getattr(ours, f)) == float(getattr(theirs, f)), f
        return
    ours = tcol.compile_collision(tlevel, device="cpu")
    theirs = interop.collision_grid(_np(jcol.compile_collision(jlevel)))
    a, b = getattr(ours, field), getattr(theirs, field)
    if isinstance(a, int):
        assert a == b
    else:
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def _assert_close_typed(name, ours, theirs):
    theirs = np.asarray(theirs)
    ours = np.broadcast_to(ours, theirs.shape)
    if theirs.dtype.kind in "biu":
        np.testing.assert_array_equal(ours, theirs, err_msg=name)
    else:
        np.testing.assert_allclose(ours, theirs, rtol=1e-6, atol=0,
                                   err_msg=name)


@pytest.mark.parametrize("settings_name", ["game", "flat_float"])
@pytest.mark.parametrize("field", Surfaces._fields)
def test_build_surfaces_flat_matches_jax(scenes, surfaces_and_prep, field,
                                         settings_name):
    tflat = scenes[4]
    cams, out = surfaces_and_prep
    settings, jsurf, _ = out[settings_name]
    tsurf = tsf.build_surfaces_flat(tflat, interop.camera_arrays(cams),
                                    settings, W, H)
    ours = getattr(tsurf, field).numpy()
    theirs = getattr(jsurf, field)
    assert ours.dtype == theirs.dtype
    exact = ("valid", "sx", "sy") if settings.use_fixed_point else ("valid",)
    if field in exact:
        # culling and the snapped integer screen coords decide everything
        # downstream; the float projection's coords carry the FMA ulps
        np.testing.assert_array_equal(np.broadcast_to(ours, theirs.shape),
                                      theirs)
    else:
        _assert_close_typed(field, ours, theirs)


@pytest.mark.parametrize("settings_name", ["game", "flat_float"])
@pytest.mark.parametrize("field", trb.BatchPrep._fields)
def test_prep_instance_matches_jax(scenes, surfaces_and_prep, field,
                                   settings_name):
    tflat, tstatic = scenes[4], scenes[5]
    _, out = surfaces_and_prep
    _, jsurf, jprep = out[settings_name]
    ours = trb.prep_instance(interop.surfaces(jsurf), tflat.atlas, W, H)
    theirs = interop.batch_prep(jprep, tstatic.n_faces)
    assert int(ours.count.min()) > 0
    np.testing.assert_array_equal(getattr(ours, field).numpy(),
                                  getattr(theirs, field).numpy())


def test_camera_builders_match_jax():
    from bonnie32_tpu_torch.models import build as tbuild
    for pitch, yaw in ((0.0, 0.0), (0.25, 0.6), (-0.7, 3.6), (1.2, -2.0)):
        pos = np.asarray([1.5, -2.0, 300.0], np.float32)
        ours = tbuild.make_camera(pos, tbuild.camera_basis(pitch, yaw))
        theirs = _np(jbuild.make_camera(pos, jbuild.camera_basis(pitch,
                                                                  yaw)))
        np.testing.assert_array_equal(ours.position.numpy(),
                                      theirs.position)
        np.testing.assert_array_equal(ours.basis.numpy(), theirs.basis)


LIGHT_SPECS = [
    dict(kind="directional", direction=(-1.0, -1.0, -1.0), intensity=0.7,
         color=(255, 240, 200)),
    dict(kind="point", position=(300.0, 800.0, -200.0), radius=2500.0,
         intensity=1.2, color=(90, 160, 255)),
    dict(kind="spot", position=(-400.0, 1500.0, 300.0),
         direction=(0.2, -1.0, 0.1), radius=4000.0, angle=0.6,
         intensity=0.9),
    dict(kind="point", position=(0.0, 0.0, 0.0), enabled=False)]


def test_lights_and_shade_points_match_jax():
    """Compile-time shading with every light kind: lights exact, shades to
    rtol 1e-6 (XLA:CPU contracts FMAs; spot lights' acos is libm's)."""
    from bonnie32_tpu.ops import lighting as jlight
    from bonnie32_tpu_torch.models import build as tbuild
    from bonnie32_tpu_torch.ops import lighting as tlight
    tl = tbuild.lights_from_list(LIGHT_SPECS)
    jl = _np(jbuild.lights_from_list(LIGHT_SPECS))
    for f in tl._fields:
        np.testing.assert_array_equal(getattr(tl, f).numpy(),
                                      getattr(jl, f), err_msg=f)
    rng = np.random.default_rng(5)
    nrm = rng.normal(size=(2000, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    pos = rng.uniform(-2000, 2000, (2000, 3)).astype(np.float32)
    amb = rng.uniform(0.1, 0.9, 2000).astype(np.float32)
    ours = tlight.shade_points(torch.from_numpy(nrm), torch.from_numpy(pos),
                               tl, ambient=torch.from_numpy(amb)).numpy()
    theirs = np.asarray(jlight.shade_points(
        jnp.asarray(nrm), jnp.asarray(pos), jbuild.lights_from_list(
            LIGHT_SPECS), ambient=jnp.asarray(amb)))
    assert (ours > amb[:, None]).any() and (ours == 1.0).any()
    np.testing.assert_allclose(ours, theirs, rtol=1e-6, atol=1e-7)


def test_keyable_faces_are_kept(surfaces_and_prep, scenes):
    tflat = scenes[4]
    _, out = surfaces_and_prep
    prep = trb.prep_instance(interop.surfaces(out["game"][1]), tflat.atlas,
                             W, H)
    kept = (torch.arange(prep.order.shape[1])[None] < prep.count[:, None])
    keyable = torch.gather(prep.ctrl[..., trb.K_KEY], 1, prep.order.long())
    assert bool((keyable.bool() & kept).any())
    assert bool((~keyable.bool() & kept).any())


@pytest.mark.parametrize("variant", [
    "ortho", "transparent_not_last", "transparent_perspective_not_last",
    "backface_wires_two_groups"])
def test_unported_configurations_raise(scenes, variant):
    """What the kernel route cannot draw raises when render_level_flat is
    called directly (rollout.step_and_render sends it to the sequential
    renderer): ortho projection, transparent faces outside the last draw
    group (also with perspective UVs), backface wires over several draw
    groups."""
    from bonnie32_tpu_torch.config import OrthoProjection
    tlevel, tflat, tstatic = scenes[1], scenes[4], scenes[5]
    game = RasterSettings.game()
    settings = {
        "ortho": dataclasses.replace(
            game, ortho_projection=OrthoProjection(1.0, 0.0, 0.0)),
        "transparent_perspective_not_last": dataclasses.replace(
            game, affine_textures=False),
        "backface_wires_two_groups": RasterSettings(),
    }.get(variant, game)
    static = tstatic
    if variant.startswith("transparent"):
        # a transparent face in a group before the last: the per-room
        # interleave of the sequential renderer
        static = dataclasses.replace(tstatic, transparent_idx=(3,),
                                     transparent_last=False)
    elif variant == "backface_wires_two_groups":
        # the reference draws each group's wires after that group's
        # solids, which a wire pass after all solids cannot reproduce
        static = dataclasses.replace(tstatic, n_draw_groups=2)
    cams = interop.camera_arrays(_np(jbuild.make_camera(
        np.zeros(3, np.float32), jbuild.camera_basis(0.2, 0.3))))
    cams = type(cams)(*(x[None] for x in cams))
    with pytest.raises(NotImplementedError):
        tsf.render_level_flat(tflat, static, cams, settings, H, W)


def sky_cave_level(L):
    """The Cave-size level with a default skybox config."""
    level = ts.cave_size_level(L)
    level.skybox = {"enabled": True}
    return level


# The configurations that raised before the port drew them: variant ->
# (level function, textures, level key of POSES, settings keywords), each
# rendered on the CPU and held against the JAX package — its kernel path
# (interpret mode; transparent faces through its sequential compositor
# under perspective UVs), or for x-ray with perspective UVs, which its
# kernel path refuses, its sequential renderer.  Two draw through the
# sequential renderer's own modules: "non_flat", the 8-bit pipeline
# (compile_level(with_8bit=True), render_level with use_rgb555=False, on
# a frame cleared to F32_MAX), and "skybox", the level's sky as the exact
# mesh walk (render_skybox(exact=True)).
SEQUENTIAL = ("non_flat", "skybox")
PORTED = {
    "non_flat": (ts.cave_size_level, ts.textures, "cave",
                 dict(use_rgb555=False)),
    "skybox": (sky_cave_level, ts.textures, "cave", {}),
    "perspective_uv": (ts.cave_size_level, ts.textures, "cave",
                       dict(affine_textures=False)),
    "transparent_perspective_uv": (ts.transparent_cave_level,
                                   ts.transparent_textures, "cave",
                                   dict(affine_textures=False)),
    "xray_perspective_uv": (ts.transparent_cave_level,
                            ts.transparent_textures, "cave",
                            dict(affine_textures=False, xray_mode=True)),
    "wire_overlay": (ts.two_room_level, ts.textures, "two_room",
                     dict(wireframe_overlay=True)),
    "backface_wires": (ts.cave_size_level, ts.textures, "cave",
                       dict(backface_wireframe=True)),
}


@pytest.fixture(scope="module")
def ported_refs():
    """The JAX frames of every PORTED case, computed once."""
    from bonnie32_tpu.models import scene as jscene
    from bonnie32_tpu.ops import raster_ref
    out = {}
    fb0 = raster_ref.new_framebuffer(H, W, depth_mode="inv")
    for variant, (build, textures, key, kw) in PORTED.items():
        level = build(JL)
        settings = dataclasses.replace(RasterSettings.game(), **kw)
        cams = [jbuild.make_camera(np.asarray(p, np.float32),
                                   jbuild.camera_basis(pi, ya))
                for p, pi, ya in POSES[key]]
        cams = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *cams)
        if variant == "non_flat":
            seq = jscene.compile_level(level, textures(), ts.resolver,
                                       with_8bit=True)
            fbh = raster_ref.new_framebuffer(H, W, depth_mode="harmonic")
            color = jax.vmap(lambda c: jscene.render_level(
                fbh, seq, c, settings).color)(cams)
            out[variant] = (_np(cams), np.asarray(color))
            continue
        if variant == "skybox":
            from bonnie32_tpu.models import skybox as jskybox
            from bonnie32_tpu.ops import skybox as jsky
            tables = jsky.build_sky_tables(
                jskybox.Skybox.from_ron(level.skybox))
            color = jax.vmap(lambda c: jsky.render_skybox(
                fb0, tables, c, exact=True).color)(cams)
            out[variant] = (_np(cams), np.asarray(color))
            continue
        jflat, jstatic = jsf.compile_level_flat(level, textures(),
                                                ts.resolver)
        if jsf.kernel_path_ok(jstatic, settings):
            fbs = jax.tree_util.tree_map(
                lambda x: jnp.broadcast_to(x, (len(POSES[key]),) + x.shape),
                fb0)
            color = jsf.render_level_flat(fbs, jflat, jstatic, cams,
                                          settings, height=H, width=W,
                                          interpret=True).color
        else:
            assert variant == "xray_perspective_uv"
            seq = jscene.compile_level(level, textures(), ts.resolver)
            color = jax.vmap(lambda c: jscene.render_level(
                fb0, seq, c, settings).color)(cams)
        out[variant] = (_np(cams), np.asarray(color))
    return out


def _port_sequential(variant, level, textures, cams, settings):
    """The port's frames of a SEQUENTIAL variant on the CPU."""
    n = cams.position.shape[0]
    if variant == "non_flat":
        scene = tscene.compile_level(level, textures, ts.resolver,
                                     with_8bit=True, device="cpu")
        fb = traster_ref.new_framebuffer(H, W, depth_mode="harmonic", n=n,
                                         device="cpu")
        return tscene.render_level(fb, scene, cams, settings)
    env = trollout.build_env(level, textures, ts.resolver, device="cpu")
    fb = traster_ref.new_framebuffer(H, W, depth_mode="inv", n=n,
                                     device="cpu")
    return tsky.render_skybox(env.sky, cams, H, W, exact=True, fb=fb)


@pytest.mark.parametrize("variant", sorted(PORTED))
def test_ported_configurations_match_jax(ported_refs, variant):
    """Perspective UVs (opaque, transparent, x-ray), the wireframe overlay
    on two draw groups, backface wires on one and the 8-bit pipeline: the
    port's CPU render within the seam budget max(64*N, pixels/500) of the
    JAX package's (XLA:CPU contracts FMAs; the overlay alone is exact).
    The exact sky mesh within tests/test_skybox.py's budget: one step a
    channel on under 5% of the pixels."""
    build, textures, _, kw = PORTED[variant]
    settings = dataclasses.replace(RasterSettings.game(), **kw)
    cams, jcolor = ported_refs[variant]
    tcams = interop.camera_arrays(cams)
    if variant in SEQUENTIAL:
        out = _port_sequential(variant, build(TL), textures(), tcams,
                               settings)
    else:
        flat, static = tsf.compile_level_flat(build(TL), textures(),
                                              ts.resolver, device="cpu")
        out = tsf.render_level_flat(flat, static, tcams, settings, H, W)
    diff = int((out.color.numpy() != jcolor).sum())
    if variant == "wire_overlay":
        assert static.n_draw_groups == 2 and diff == 0
        assert bool(out.color.any())
    elif variant == "skybox":
        step = np.zeros(jcolor.shape, np.int64)
        for sh in (0, 8, 16):
            step = np.maximum(step, np.abs(
                ((out.color.numpy() >> sh) & 255).astype(np.int64)
                - ((jcolor >> sh) & 255)))
        assert step.max() <= 1 and (step > 0).mean() < 0.05
    else:
        assert ((jcolor >> 24) & 255 == 255).mean() > 0.5
        assert diff <= max(64 * jcolor.shape[0], jcolor.size // 500), diff
