"""The port's skybox (models/skybox.py, ops/skybox.py) vs the JAX
package's on the CPU: the host config, the device tables, the sky
function, the full sky render, the scalar table of the sky kernels, the
star pass and the routing test.  No Pallas kernel runs here (the frames
through the rasterizer are in test_torch_sky_kernel.py and
test_torch_sky_rollout.py).

Inputs are the night and sunset skies of tests/torch_scenes.py and
cameras and directions from a numpy seed.  Tolerances:

  * host config, generated meshes, device tables: equal arrays (the
    port's models/skybox.py is a copy, and the star LCG is host Python);
  * `_sample_sky`: atol 0.02 of a colour unit on [0, 255] — sin, cos,
    acos and pow differ by ulps between XLA:CPU and torch, and the cloud
    noise multiplies its phase by up to 200;
  * rendered skies: at most one 8-bit step a channel, at least 99.9% of
    the pixels equal (the JAX suite's own budget between its two sky
    routes is one step on 0.1%, tests/test_skybox.py); the port takes a
    body's angle from a dot product with its direction, as the TPU kernel
    does, where `render_skybox` of the JAX package runs the sin/cos chain;
  * against the numpy sampler at the same directions: one step, 97%
    exact (tests/test_skybox.py's budget for its own fast path);
  * the scalar table: vertices, bboxes and 1/dnm of valid faces rtol
    2e-4 — a mountain vertex just in front of the camera has a rotated z
    of a few units left from terms of 1e4, so XLA:CPU's contracted dot
    product and the port's left-to-right sum differ by 1e-4 of it, and
    the projection divides by it; the basis row, the time and the empty
    boxes of invalid faces exact;
  * stars: equal planes;
  * the exact mesh walk (render_skybox(exact=True)): one step on under
    5% of the pixels, tests/test_skybox.py's budget for it
    (test_torch_skybox_exact.py holds it against the numpy golden).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_scenes as ts
from bonnie32_tpu.config import PROJ_DISTANCE, PROJ_SCALE, RasterSettings
from bonnie32_tpu.models import build as jbuild
from bonnie32_tpu.models import skybox as JS
from bonnie32_tpu.ops import raster_batch as jrb
from bonnie32_tpu.ops import raster_ref
from bonnie32_tpu.ops import skybox as jsky
from bonnie32_tpu_torch import interop
from bonnie32_tpu_torch.models import skybox as TS
from bonnie32_tpu_torch.ops import raster_ref as raster_ref_t
from bonnie32_tpu_torch.ops import skybox as tsky

torch.set_num_threads(1)

H, W = 120, 160
POSES = ((0.15, 0.9), (-0.2, 2.5), (0.4, 4.0))
SKIES = ("night", "sunset")
PRESETS = ("preset_sunset", "preset_twilight", "preset_arctic",
           "preset_night")
_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731


def _channels(word):
    return np.stack([(word >> s) & 255 for s in (0, 8, 16, 24)],
                    -1).astype(np.int64)


def assert_sky_close(ours, theirs, min_exact=0.999):
    step = np.abs(_channels(ours) - _channels(theirs)).max(-1)
    assert step.max() <= 1, f"{(step > 1).sum()} pixels beyond one step"
    assert (step == 0).mean() >= min_exact, \
        f"only {(step == 0).mean():.4%} of the pixels equal"


def _jax_cams():
    cams = [jbuild.make_camera((0.0, 0.0, 0.0), jbuild.camera_basis(p, y))
            for p, y in POSES]
    return cams, jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *cams)


@pytest.fixture(scope="module")
def refs():
    """Every JAX reference of the module, computed once."""
    out = {}
    cams, stacked = _jax_cams()
    out["cams"] = _np(stacked)
    fb = raster_ref.new_framebuffer(H, W, depth_mode="inv")
    for name in SKIES:
        tables = jsky.build_sky_tables(ts.sky_config(JS, name))
        out[name, "tables"] = _np(tables)
        out[name, "render"] = np.stack([np.asarray(jsky.render_skybox(
            fb, tables, c, time=0.25).color) for c in cams])
        if name == "night":
            out[name, "exact"] = np.stack([np.asarray(jsky.render_skybox(
                fb, tables, c, time=0.25, exact=True).color) for c in cams])
        out[name, "scal"] = np.stack([np.asarray(jsky.prep_sky_scal(
            tables, c, W, H)) for c in cams])
        if name == "night":
            stars = [jsky.render_skybox_layout(tables, c, H, W, time=0.25,
                                               parts="stars") for c in cams]
            out["stars"] = np.asarray(jrb.from_layout(jnp.stack(stars), W, H))
    return out


def _port_tables(name):
    return tsky.build_sky_tables(ts.sky_config(TS, name), device="cpu")


# ---- host config: the copy against the original ----

@pytest.mark.parametrize("preset", PRESETS)
def test_skybox_ron_round_trip_matches_original(preset):
    ours = getattr(TS.Skybox, preset)()
    theirs = getattr(JS.Skybox, preset)()
    assert ours.freeze() == theirs.freeze()
    back = TS.Skybox.from_ron(ours.to_ron())
    jback = JS.Skybox.from_ron(theirs.to_ron())
    assert back.freeze() == jback.freeze()
    # f32 fields round once on the way out and stay put afterwards
    assert TS.Skybox.from_ron(back.to_ron()).freeze() == back.freeze()


@pytest.mark.parametrize("preset", PRESETS)
def test_sample_at_direction_matches_original(preset):
    rng = np.random.default_rng(11)
    theta = rng.uniform(0, 2 * np.pi, 4000).astype(np.float32)
    phi = rng.uniform(0, np.pi, 4000).astype(np.float32)
    ours = getattr(TS.Skybox, preset)().sample_at_direction(theta, phi, 0.5)
    theirs = getattr(JS.Skybox, preset)().sample_at_direction(theta, phi,
                                                              0.5)
    np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("preset", PRESETS)
def test_generated_meshes_match_original(preset):
    ours, theirs = getattr(TS.Skybox, preset)(), getattr(JS.Skybox, preset)()
    for a, b in zip(ours.generate_mountains(0.3),
                    theirs.generate_mountains(0.3)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(ours.generate_sphere(0.3, 12, 8),
                    theirs.generate_sphere(0.3, 12, 8)):
        np.testing.assert_array_equal(a, b)


# ---- device tables ----

@pytest.mark.parametrize("name", SKIES)
def test_build_sky_tables_matches_jax(refs, name):
    ours = _port_tables(name)
    carried = interop.sky_tables(refs[name, "tables"],
                                 ts.sky_config(TS, name))
    for f in ours._fields:
        a, b = getattr(ours, f), getattr(carried, f)
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=f)
        elif f != "skybox":
            assert a == b, f
    assert ours.face_table.shape[0] > 0
    assert ours.vpad >= ours.face_table.shape[0]


def test_build_sky_tables_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tsky.build_sky_tables(TS.Skybox.preset_night())


def test_sky_without_mountains_or_clouds():
    sb = dataclasses.replace(TS.Skybox.preset_night(),
                             mountain_ranges=[None, None])
    tables = tsky.build_sky_tables(sb, device="cpu")
    assert tables.face_table.shape == (0, tsky.N_FACE_COLS)
    cams = interop.camera_arrays(_np(_jax_cams()[1]))
    out = tsky.render_skybox(tables, cams, 24, 32)
    assert out.color.shape == (3, 24, 32) and not out.depth.any()
    consts = tsky.sky_consts(sb)
    assert [c["enabled"] for c in consts["cloud"]] == [0, 0]
    assert not consts["tint_enabled"]


# ---- the sky function ----

@pytest.mark.parametrize("name", SKIES)
def test_sample_sky_matches_jax(name):
    rng = np.random.default_rng(5)
    theta = rng.uniform(0, 2 * np.pi, (64, 128)).astype(np.float32)
    phi = rng.uniform(0, np.pi, (64, 128)).astype(np.float32)
    theirs = jsky._sample_sky(ts.sky_config(JS, name), jnp.asarray(theta),
                              jnp.asarray(phi), jnp.float32(0.25))
    # the port takes a body's angle from the ray the two angles stand for
    ray = (np.sin(phi) * np.cos(theta), np.cos(phi),
           np.sin(phi) * np.sin(theta))
    ours = tsky._sample_sky(ts.sky_config(TS, name),
                            torch.from_numpy(theta), torch.from_numpy(phi),
                            torch.tensor(0.25),
                            tuple(torch.from_numpy(r) for r in ray))
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=0.02)


def test_body_dot_product_equals_trig_chain():
    """The kernels' direct dot product against body_unit_dir is the trig
    chain's cos_dist (to f32 rounding)."""
    rng = np.random.default_rng(6)
    theta = rng.uniform(0, 2 * np.pi, 2000)
    phi = rng.uniform(0, np.pi, 2000)
    body = TS.Skybox.preset_night().moon
    bx, by, bz = tsky.body_unit_dir(body)
    ray = (np.sin(phi) * np.cos(theta), np.cos(phi),
           np.sin(phi) * np.sin(theta))
    body_phi = math.pi / 2 - body.elevation
    chain = (np.sin(phi) * math.sin(body_phi) * np.cos(theta - body.azimuth)
             + np.cos(phi) * math.cos(body_phi))
    np.testing.assert_allclose(ray[0] * bx + ray[1] * by + ray[2] * bz,
                               chain, rtol=0, atol=1e-12)
    assert tsky.body_unit_dir(body) == jsky.body_unit_dir(
        JS.Skybox.preset_night().moon)


# ---- the full render ----

@pytest.mark.parametrize("name", SKIES)
def test_render_skybox_matches_jax(refs, name):
    cams = interop.camera_arrays(refs["cams"])
    out = tsky.render_skybox(_port_tables(name), cams, H, W, time=0.25)
    assert not out.depth.any()
    theirs = refs[name, "render"]
    assert (_channels(theirs)[..., 3] == 255).all()
    assert_sky_close(out.color.numpy(), theirs)


def test_render_skybox_matches_host_sampler():
    """Every sphere pixel is the analytic sky function at the pixel's own
    direction: the numpy sampler at the same directions agrees within one
    step (tests/test_skybox.py's check of the JAX fast path)."""
    sb = dataclasses.replace(ts.sky_config(TS, "sunset"),
                             mountain_ranges=[None, None])
    tables = tsky.build_sky_tables(sb, device="cpu")
    basis = np.asarray(jbuild.camera_basis(0.12, 1.3), np.float32)
    cams = interop.camera_arrays(_np(jbuild.make_camera((0.0, 0.0, 0.0),
                                                        basis)))
    cams = type(cams)(*(x[None] for x in cams))
    word = tsky.render_skybox(tables, cams, H, W).color[0].numpy()
    got = _channels(word)[..., :3]

    yi, xi = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    vs = np.float32(min(W, H) / 2.0 * PROJ_SCALE)
    usq = np.float32(PROJ_DISTANCE - 1.0)
    ndc_x = (xi + 0.5 - W / 2.0).astype(np.float32) / vs / usq
    ndc_y = (yi + 0.5 - H / 2.0).astype(np.float32) / vs / usq
    norm = np.sqrt(ndc_x * ndc_x + ndc_y * ndc_y + 1.0)
    cx, cy, cz = ndc_x / norm, ndc_y / norm, 1.0 / norm
    wx = cx * basis[0, 0] + cy * basis[1, 0] + cz * basis[2, 0]
    wy = cx * basis[0, 1] + cy * basis[1, 1] + cz * basis[2, 1]
    wz = cx * basis[0, 2] + cy * basis[1, 2] + cz * basis[2, 2]
    phi = np.arccos(np.clip(wy, -1.0, 1.0)).astype(np.float32)
    theta = np.mod(np.arctan2(wz, wx), 2 * np.pi).astype(np.float32)
    want = np.clip(sb.sample_at_direction(theta, phi), 0,
                   255).astype(np.int64)
    err = np.abs(got - want).max(-1)
    assert (err <= 1).all(), f"{(err > 1).sum()} pixels beyond one step"
    assert (err == 0).mean() > 0.97


def test_render_skybox_exact_matches_jax(refs):
    """The mesh walk (exact=True) of the night sky, from the JAX package's
    own tables carried across, for every camera at time 0.25 (the stars
    twinkle): within tests/test_skybox.py's budget for it, one step a
    channel on under 5% of the pixels; depth cleared."""
    cams = interop.camera_arrays(refs["cams"])
    tables = interop.sky_tables(refs["night", "tables"],
                                ts.sky_config(TS, "night"))
    fb = raster_ref_t.new_framebuffer(H, W, depth_mode="inv", n=len(POSES),
                                      device="cpu")
    out = tsky.render_skybox(tables, cams, H, W, time=0.25, exact=True,
                             fb=fb)
    step = np.abs(_channels(out.color.numpy())
                  - _channels(refs["night", "exact"])).max(-1)
    assert step.max() <= 1, f"{(step > 1).sum()} pixels beyond one step"
    assert (step > 0).mean() < 0.05, f"{(step > 0).mean():.1%} differ"
    assert not bool(out.depth.any())


@pytest.mark.parametrize("name", SKIES)
def test_mountains_are_drawn_and_masked(refs, name):
    """The mountain mask marks exactly the pixels where the plane with
    mountains differs from the sphere alone, up to equal colours."""
    tables = _port_tables(name)
    cams = interop.camera_arrays(refs["cams"])
    scal = tsky.prep_sky_scal(tables, cams, W, H)
    plane = tsky.sky_plane_ref(tables, scal, H, W)
    bare = tsky.sky_plane_ref(
        tables._replace(face_table=tables.face_table[:0]), scal, H, W)
    mask = tsky.mountain_mask(tables, scal, H, W)
    assert int(mask.sum()) > 500
    assert torch.equal(plane[~mask], bare[~mask])
    assert (plane[mask] != bare[mask]).float().mean() > 0.9


# ---- the kernels' configuration and scalar table ----

@pytest.mark.parametrize("name", SKIES)
def test_sky_params_hold_every_constant(name):
    """The kernels' argument struct takes every constant of the plain
    version by name, and refuses a name it has no field for."""
    from bonnie32_tpu_torch.ops import _cuda
    sb = ts.sky_config(TS, name)
    k = tsky.sky_consts(sb)
    p = _cuda.sky_params(sb, W, H)
    assert p.horizon == np.float32(k["horizon"])
    assert p.tint_enabled == k["tint_enabled"]
    assert (p.half_w, p.half_h) == (W / 2.0, H / 2.0)
    for slot, body in zip(p.body, k["body"]):
        assert slot.enabled == body["enabled"]
        assert slot.dx == np.float32(body["dx"])
        assert tuple(slot.glow_color) == tuple(body["glow_color"])
    for slot, layer in zip(p.cloud, k["cloud"]):
        assert slot.enabled == layer["enabled"]
    with pytest.raises(KeyError, match="horizn"):
        _cuda._fill(_cuda.SkyParams(), {"horizn": 0.5})



@pytest.mark.parametrize("name", SKIES)
def test_prep_sky_scal_matches_jax(refs, name):
    tables = _port_tables(name)
    cams = interop.camera_arrays(refs["cams"])
    ours = tsky.prep_sky_scal(tables, cams, W, H).numpy()
    theirs = refs[name, "scal"]
    assert ours.shape == theirs.shape == (len(POSES), 8, tables.vpad)
    nf = tables.face_table.shape[0]
    valid = theirs[:, tsky.R_YMIN, :nf] <= theirs[:, tsky.R_YMAX, :nf]
    assert 0 < valid.sum() < valid.size      # some faces culled, some not
    ours_valid = ours[:, tsky.R_YMIN, :nf] <= ours[:, tsky.R_YMAX, :nf]
    np.testing.assert_array_equal(ours_valid, valid)
    np.testing.assert_array_equal(ours[:, tsky.R_BASIS], theirs[:, 3])
    for row in (tsky.R_MSX, tsky.R_MSY):
        np.testing.assert_allclose(ours[:, row], theirs[:, row], rtol=2e-4,
                                   atol=1e-3)
    for row in (tsky.R_INV, tsky.R_YMIN, tsky.R_YMAX, tsky.R_XMIN,
                tsky.R_XMAX):
        o, t = ours[:, row, :nf], theirs[:, row, :nf]
        np.testing.assert_allclose(o[valid], t[valid], rtol=2e-4, atol=1e-3)
        # invalid faces: the empty box, exactly; padding columns too
        if row != tsky.R_INV:
            np.testing.assert_array_equal(o[~valid], t[~valid])
        np.testing.assert_array_equal(ours[:, row, nf:], theirs[:, row, nf:])


def test_prep_sky_scal_carries_the_time():
    tables = _port_tables("sunset")
    cams = interop.camera_arrays(_np(_jax_cams()[1]))
    default = tsky.prep_sky_scal(tables, cams, W, H)
    later = tsky.prep_sky_scal(tables, cams, W, H, time=7.5)
    assert float(default[0, tsky.R_BASIS, tsky.C_TIME]) == tables.time
    assert float(later[1, tsky.R_BASIS, tsky.C_TIME]) == 7.5
    a = tsky.sky_plane_ref(tables, default, 48, 64)
    b = tsky.sky_plane_ref(tables, later, 48, 64)
    assert (a != b).any(), "the clouds scroll with the time"


# ---- stars ----

BLACK = -16777216            # alpha 255, rgb 0, as an i32 word


def test_star_pass_matches_jax(refs):
    tables = _port_tables("night")
    cams = interop.camera_arrays(refs["cams"])
    plane = torch.full((len(POSES), H, W), BLACK, dtype=torch.int32)
    ours = tsky.scatter_stars(plane, None, tables, cams, time=0.25).numpy()
    theirs = refs["stars"]
    stars = theirs != BLACK
    assert stars.sum() >= 9 * 5, "whole sparkles are in view"
    np.testing.assert_array_equal(ours, theirs)
    # the dim outer arms are there: three brightness classes per star
    assert len(np.unique(theirs[stars])) > 3


def test_star_pass_respects_depth_and_order():
    """Stars land only where depth is 0.0; of two sparkles on one pixel
    the later offset wins, and within one offset the later star."""
    tables = _port_tables("night")
    cams = interop.camera_arrays(_np(_jax_cams()[1]))
    plane = torch.full((len(POSES), H, W), BLACK, dtype=torch.int32)
    depth = torch.zeros(plane.shape)
    depth[:, :, : W // 2] = 0.5
    masked = tsky.scatter_stars(plane, depth, tables, cams)
    free = tsky.scatter_stars(plane, None, tables, cams)
    assert (masked[:, :, : W // 2] == BLACK).all()
    assert torch.equal(masked[:, :, W // 2:], free[:, :, W // 2:])
    assert (free[:, :, : W // 2] != BLACK).any()
    # sequential reference: offsets in order, stars in order
    want = plane.clone()
    xs, ys, ok, words = tsky._star_writes(tables, cams, H, W, 0.0)
    for o in range(len(tsky.STAR_OFFSETS)):
        for i in range(len(POSES)):
            for s in np.flatnonzero(ok[i, o].numpy()):
                want[i, int(ys[i, o, s]), int(xs[i, o, s])] = words[o, s]
    assert torch.equal(free, want)


def test_disabled_stars_draw_nothing():
    sb = ts.sky_config(TS, "night")
    off = dataclasses.replace(sb, stars=dataclasses.replace(sb.stars,
                                                            enabled=False))
    tables = tsky.build_sky_tables(off, device="cpu")
    cams = interop.camera_arrays(_np(_jax_cams()[1]))
    plane = torch.full((len(POSES), 48, 64), BLACK, dtype=torch.int32)
    assert torch.equal(tsky.scatter_stars(plane, None, tables, cams), plane)


# ---- routing ----

class _Static:
    def __init__(self, tr):
        self.transparent_idx = tr


def _routing_cases():
    game = RasterSettings.game()
    return {
        "opaque": ("night", (), game, True),
        "stars_and_transparent": ("night", (3, 5), game, False),
        "xray": ("night", (), RasterSettings.game(xray_mode=True), False),
        "painters": ("night", (), RasterSettings.game(use_zbuffer=False),
                     False),
        "starless_transparent": ("starless", (3, 5), game, True),
    }


@pytest.mark.parametrize("case", sorted(_routing_cases()))
def test_sky_kernel_ok_matches_jax(case):
    sky, tr, settings, want = _routing_cases()[case]

    def config(S):
        sb = S.Skybox.preset_night()
        if sky == "starless":
            sb = dataclasses.replace(sb, stars=dataclasses.replace(
                sb.stars, enabled=False))
        return sb

    ours = tsky.build_sky_tables(config(TS), device="cpu")
    theirs = jsky.build_sky_tables(config(JS))
    assert tsky.sky_kernel_ok(ours, _Static(tr), settings) is want
    assert jsky.sky_kernel_ok(theirs, _Static(tr), settings) is want
    assert not tsky.sky_kernel_ok(None, _Static(tr), settings)
