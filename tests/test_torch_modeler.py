"""The port's modeler modules (models/animation.py,
models/modeler_viewport.py, editor/model_browser.py) against the JAX
package's, on the CPU, on inputs built in code with each package's own
classes:

  * animation math: rotate_by_euler and its inverse on seeded vectors and
    angles, pose_bones (a batch of seeded pose frames) and bone_tips on a
    five-bone rig, bone_world_transform / bone_tip_position and
    skeleton_to_triangles: floats within rtol 1e-5 / atol 1e-3 (world
    units up to ~1000; sin, cos and XLA:CPU's FMAs differ by ulps),
    topology, colours and face fields exact; Animation.sample and the RON
    round trip of the host classes equal;
  * the modeler's four panes of a two-part MeshProject (and a hidden
    part), composited into a UiContext and painted; the skeleton overlay
    (render_view_with_skeleton, posed); project_arrays field by field,
    exact;
  * AssetBrowser.render_preview of tests/torch_scenes.py's two-part asset
    with its user texture.
Rendered frames compare within the seam budget max(64 N, pixels / 500)
(XLA:CPU contracts FMAs in the rasterizer); the skeleton over a render
within max(2, bones / 50), 2% of the pixels the reference's bones
changed, so bones drawn in the wrong place fail.  The measured count is
printed.
"""

import types

import numpy as np
import pytest
import torch

import torch_editor_cases as ec
import torch_scenes as ts

torch.set_num_threads(1)

PH, PW = 120, 160           # one pane
RTOL, ATOL = 1e-5, 1e-3


def _pkg(which):
    if which == "jax":
        from bonnie32_tpu import config, ui
        from bonnie32_tpu.editor import model_browser
        from bonnie32_tpu.models import animation, asset, build, mesh
        from bonnie32_tpu.models import modeler_viewport, user_texture
        from bonnie32_tpu.types import FrameBuffers
        import jax.numpy as jnp

        def blank(h, w):
            return FrameBuffers(color=jnp.zeros((h, w), jnp.int32),
                                depth=jnp.zeros((h, w), jnp.float32))

        def words(fb):
            return np.asarray(fb.color)
        kw = {}
    else:
        from bonnie32_tpu_torch import config, ui
        from bonnie32_tpu_torch.editor import model_browser
        from bonnie32_tpu_torch.models import animation, asset, build, mesh
        from bonnie32_tpu_torch.models import modeler_viewport, user_texture
        from bonnie32_tpu_torch.types import FrameBuffers

        def blank(h, w):
            return FrameBuffers(
                color=torch.zeros((1, h, w), dtype=torch.int32),
                depth=torch.zeros((1, h, w)))

        def words(fb):
            return fb.color[0].numpy()
        kw = dict(device="cpu")
    return types.SimpleNamespace(
        C=config, ui=ui, MB=model_browser, AN=animation, A=asset, B=build,
        M=mesh, MV=modeler_viewport, U=user_texture, blank=blank,
        words=words, kw=kw)


PKGS = {k: _pkg(k) for k in ("jax", "port")}
PORT, JAX = PKGS["port"], PKGS["jax"]


def seam_budget(npixels, n_inst=1):
    return max(64 * n_inst, npixels // 500)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(ours, theirs, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(_np(ours), _np(theirs), rtol=rtol, atol=atol)


# ---- animation math ----

def test_rotate_by_euler_both_ways():
    r = np.random.default_rng(1)
    v = r.uniform(-500, 500, (64, 3)).astype(np.float32)
    rot = r.uniform(-180, 180, (64, 3)).astype(np.float32)
    for name in ("rotate_by_euler", "inverse_rotate_by_euler"):
        ours = getattr(PORT.AN, name)(torch.from_numpy(v),
                                      torch.from_numpy(rot))
        _close(ours, getattr(JAX.AN, name)(v, rot))
    back = PORT.AN.inverse_rotate_by_euler(
        PORT.AN.rotate_by_euler(torch.from_numpy(v), torch.from_numpy(rot)),
        torch.from_numpy(rot))
    _close(back, v, atol=1e-2)
    # one rotation broadcast over many vectors
    _close(PORT.AN.rotate_by_euler(torch.from_numpy(v), rot[0]),
           JAX.AN.rotate_by_euler(v, rot[0]))


def test_pose_bones_and_tips():
    """A batch of 6 seeded pose frames at once in the port, each frame
    alone in JAX."""
    parent, lp, lr, ln = PORT.AN.bones_to_arrays(ec.rig(PORT.AN))
    jparent, jlp, jlr, jln = JAX.AN.bones_to_arrays(ec.rig(JAX.AN))
    for a, b in zip((parent, lp, lr, ln), (jparent, jlp, jlr, jln)):
        np.testing.assert_array_equal(_np(a), _np(b))
        assert a.device.type == "cpu"
    r = np.random.default_rng(2)
    pp = r.uniform(-30, 30, (6, 5, 3)).astype(np.float32)
    pr = r.uniform(-40, 40, (6, 5, 3)).astype(np.float32)
    wp, wr = PORT.AN.pose_bones(parent, lp, lr, torch.from_numpy(pp),
                                torch.from_numpy(pr))
    tips = PORT.AN.bone_tips(wp, wr, ln)
    assert tuple(wp.shape) == (6, 5, 3) and tuple(tips.shape) == (6, 5, 3)
    for f in range(6):
        jwp, jwr = JAX.AN.pose_bones(jparent, jlp, jlr, pp[f], pr[f])
        _close(wp[f], jwp)
        _close(wr[f], jwr)
        _close(tips[f], JAX.AN.bone_tips(jwp, jwr, jln))
    # the bind pose
    wp0, wr0 = PORT.AN.pose_bones(parent, lp, lr)
    jwp0, jwr0 = JAX.AN.pose_bones(jparent, jlp, jlr)
    _close(wp0, jwp0)
    _close(wr0, jwr0)


@pytest.mark.parametrize("posed", [False, True], ids=["bind", "posed"])
def test_bone_transforms_and_skeleton_triangles(posed):
    bones, jbones = ec.rig(PORT.AN), ec.rig(JAX.AN)
    pose = ec.pose(PORT.AN) if posed else None
    jpose = ec.pose(JAX.AN) if posed else None
    for i in range(5):
        a = PORT.AN.bone_world_transform(bones, i, pose)
        b = JAX.AN.bone_world_transform(jbones, i, jpose)
        assert isinstance(a[0], np.ndarray) and a[0].dtype == np.float32
        _close(a[0], b[0])
        _close(a[1], b[1])
        _close(PORT.AN.bone_tip_position(bones, i, pose),
               JAX.AN.bone_tip_position(jbones, i, jpose))
    verts, faces = PORT.AN.skeleton_to_triangles(bones, 200, pose)
    jverts, jfaces = JAX.AN.skeleton_to_triangles(jbones, 200, jpose)
    assert faces == jfaces and len(verts) == len(jverts) == 30
    for key in ("pos", "normal"):
        _close([v[key] for v in verts], [v[key] for v in jverts])
    for key in ("uv", "color", "color_blend"):
        assert [v[key] for v in verts] == [v[key] for v in jverts]


def test_animation_host_classes_match():
    out = []
    for p in (PORT, JAX):
        AN = p.AN
        anim = AN.Animation(name="walk", fps=12, looping=True)
        for frame, k in ((0, 0), (6, 1), (18, 2)):
            kf = AN.Keyframe.new(frame, 3)
            kf.transforms[1] = AN.BoneTransform((k * 10.0, 0.0, -k * 5.0),
                                                (k * 15.0, 0.0, k * 7.5))
            anim.set_keyframe(kf)
        samples = [[(t.position, t.rotation) for t in anim.sample(s)]
                   for s in (0.0, 0.25, 0.9, 1.6, 3.2)]
        rig = AN.RiggedModel(name="r", skeleton=ec.rig(p.AN))
        out.append(repr((samples, anim.duration(), anim.to_ron(),
                         [b.to_ron() for b in rig.skeleton],
                         [b.display_width() for b in rig.skeleton],
                         AN.Animation.from_ron(anim.to_ron()).to_ron())))
    assert out[0] == out[1]


# ---- the modeler's panes ----

def _scene(p):
    mesh, fa, atlas = p.MV.project_arrays(ec.mesh_project(p.M))
    lights = p.B.lights_from_list(ts.DEFAULT_LIGHT_SPECS, ambient=0.5)
    return mesh, fa, atlas, lights


def test_project_arrays_match():
    ours, theirs = PORT.MV.project_arrays(ec.mesh_project(PORT.M)), \
        JAX.MV.project_arrays(ec.mesh_project(JAX.M))
    for a, b in zip(ours, theirs):
        for f in a._fields:
            if f in b._fields:
                np.testing.assert_array_equal(_np(getattr(a, f)),
                                              _np(getattr(b, f)), err_msg=f)
    assert int(ours[0].pos.shape[0]) == 48       # the hidden part left out


@pytest.fixture(scope="module")
def panes():
    out = {}
    bounds = {k: p.ui.Rect(0, 0, 2 * PW, 2 * PH) for k, p in PKGS.items()}
    for k, p in PKGS.items():
        frames = p.MV.render_all_views(
            ec.viewports(p.MV), *_scene(p), p.C.RasterSettings.modeler(),
            bounds[k], pane_h=PH, pane_w=PW, **p.kw)
        out[k] = (frames, bounds[k])
    return out


def test_four_views_match_jax(panes):
    ours, theirs = panes["port"][0], panes["jax"][0]
    assert [v.value for v in ours] == [v.value for v in theirs]
    diff = 0
    for (view, fb), jfb in zip(ours.items(), theirs.values()):
        assert tuple(fb.color.shape) == (1, PH, PW)
        w = PORT.words(fb)
        d = int((w != JAX.words(jfb)).sum())
        print(f"{view.value}: {d} differing pixels, "
              f"{int((w != w.reshape(-1)[0]).sum())} drawn")
        assert (w != w.reshape(-1)[0]).sum() > 200, f"{view} is empty"
        diff += d
    assert diff <= seam_budget(4 * PH * PW, 4)


def test_composite_views_and_paint(panes):
    out = {}
    for k, p in PKGS.items():
        frames, bounds = panes[k]
        ctx = p.ui.UiContext()
        ctx.begin_frame(0, 0, False)
        p.MV.composite_views(ctx, ec.viewports(p.MV), frames, bounds)
        out[k] = p.words(ctx.paint(p.blank(2 * PH, 2 * PW)))
    diff = int((out["port"] != out["jax"]).sum())
    print(f"composite: {diff} differing pixels")
    assert diff <= seam_budget(4 * PH * PW, 4)
    w = out["port"]
    for q in (w[:PH, :PW], w[:PH, PW:], w[PH:, :PW], w[PH:, PW:]):
        assert (q != 0).sum() > 200


@pytest.mark.parametrize("view", ["perspective", "front"])
def test_skeleton_overlay_matches_jax(view):
    out = {}
    for k, p in PKGS.items():
        vp = ec.viewports(p.MV)
        vid = p.MV.ViewportId(view)
        args = (vp, vid, *_scene(p), p.C.RasterSettings.modeler(), PH, PW)
        base = p.words(p.MV.render_view(*args, **p.kw))
        fb = p.MV.render_view_with_skeleton(
            *args, ec.rig(p.AN), pose=ec.pose(p.AN), **p.kw)
        out[k] = (base, p.words(fb))
    (base, ours), (jbase, theirs) = out["port"], out["jax"]
    assert int((base != jbase).sum()) <= seam_budget(PH * PW)
    bones, our_bones = theirs != jbase, ours != base
    # a pixel either package's bones drew must agree
    diff = int(((ours != theirs) & (bones | our_bones)).sum())
    budget = max(2, int(bones.sum()) // 50)
    print(f"skeleton, {view}: {diff} differing bone pixels, the "
          f"reference's bones changed {int(bones.sum())}, the port's "
          f"{int(our_bones.sum())} (budget {budget})")
    assert int(our_bones.sum()) > 50
    assert diff <= budget


def test_asset_preview_matches_jax():
    out = {}
    for k, p in PKGS.items():
        lib = ts.asset_library(p.A, p.M)
        asset = lib.assets[ts.ASSET_ID]
        b = p.MB.AssetBrowser()
        b.orbit_distance = 2200.0
        b.orbit_center = (0.0, 300.0, 0.0)
        fb = b.render_preview(asset, user_textures=ts.user_textures(p.U),
                              height=PH, width=PW, **p.kw)
        out[k] = p.words(fb)
        cam = b.preview_camera()
        out[k + "_cam"] = (_np(cam.position), _np(cam.basis))
    np.testing.assert_array_equal(out["port_cam"][0], out["jax_cam"][0])
    np.testing.assert_array_equal(out["port_cam"][1], out["jax_cam"][1])
    w = out["port"]
    diff = int((w != out["jax"]).sum())
    print(f"asset preview: {diff} differing pixels, "
          f"{int((w != w.reshape(-1)[0]).sum())} drawn")
    assert (w != w.reshape(-1)[0]).sum() > 500
    assert diff <= seam_budget(PH * PW)


def test_modeler_entry_points_need_a_device_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is the card")
    vp = ec.viewports(PORT.MV)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        PORT.MV.render_view(vp, PORT.MV.ViewportId.TOP, *_scene(PORT),
                            PORT.C.RasterSettings.modeler(), PH, PW)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        PORT.MB.AssetBrowser().render_preview(
            ts.asset_library(PORT.A, PORT.M).assets[ts.ASSET_ID])
