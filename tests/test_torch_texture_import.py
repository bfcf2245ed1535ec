"""The port's texture import path (models/quantize.py, texture/paint.py,
texture/import_image.py; host copies) against the JAX package's, on the
CPU, and the imported texture through the port's main path:

  * quantize_image on seeded images in every mode (standard, preserve
    detail, smooth), with the options (perceptual weight, saturation bias,
    pre-quantize, minimum bucket fraction), in LAB, at 4 and 8 bpp:
    indices and CLUT words equal; the LAB conversions, median_cut,
    nearest_in_palette, count_unique_colors and optimal_clut_depth equal;
    on the exact modes also the scalar golden transcription's palette and
    indices (tests/golden/quantize_golden.py, as tests/test_quantize.py);
  * the paint tools over a seeded script (brushes, lines, rectangles,
    ellipses, flood fills, select-by-colour masks, selections cut, moved
    and stamped, undo, redo, eyedropper): every return value and the
    texture's indices and palette after every step equal;
  * the import dialog: resize_to_target in its three modes, atlas cells,
    crop selections, and TextureImportState from a PNG written into
    tmp_path (Pillow) at 4 and 8 bpp: preview indices, palette, the
    finalized UserTexture and its `to_texture15` words equal;
  * the slice as a whole: the 96x80 seeded image of
    tests/torch_ui_cases.py imported at 4 and 8 bpp replaces the FLOOR
    texture of the Cave-size level; `entry.entry` on the CPU (the main
    path's kernels' plain versions) draws it against the JAX kernel path
    (Pallas interpret mode) at 24x32, N=4.

Tolerance: none for the host copies (bit for bit).  The frames are held
to tests/test_raster_batch.py's seam budget, max(64 N, pixels / 500), as
tests/test_torch_entry.py holds the same path (XLA:CPU contracts FMAs).
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import torch_scenes as ts
import torch_ui_cases as uc
from bonnie32_tpu import rollout as jrollout
from bonnie32_tpu import texture as jtex
from bonnie32_tpu.config import RasterSettings as JRasterSettings
from bonnie32_tpu.game import step as jstep
from bonnie32_tpu.models import level as JL
from bonnie32_tpu.models import quantize as jq
from bonnie32_tpu.models.user_texture import UserTexture as JUserTexture
from bonnie32_tpu_torch import entry, rollout
from bonnie32_tpu_torch import texture as ttex
from bonnie32_tpu_torch.config import RasterSettings
from bonnie32_tpu_torch.models import level as TL
from bonnie32_tpu_torch.models import quantize as tq
from bonnie32_tpu_torch.models.user_texture import UserTexture
from golden import quantize_golden as gold

torch.set_num_threads(1)

H, W, N = 24, 32, 4


def random_image(w, h, ncolors, seed, alpha_holes=True):
    """tests/test_quantize.py's image: ncolors random colours, ~10%
    transparent."""
    rng = np.random.default_rng(seed)
    pal = rng.integers(0, 256, size=(ncolors, 3), dtype=np.uint8)
    idx = rng.integers(0, ncolors, size=(h, w))
    img = np.zeros((h, w, 4), np.uint8)
    img[..., :3] = pal[idx]
    img[..., 3] = 255
    if alpha_holes:
        img[rng.random((h, w)) < 0.1, 3] = 0
    return img


QUANTIZE_CASES = {
    "standard bpp8": (24, 16, 600, 0, 1, {}),
    "standard bpp4": (16, 16, 200, 1, 0, {}),
    "preserve detail": (20, 20, 300, 2, 0, dict(mode="preserve_detail")),
    "smooth": (20, 20, 300, 3, 0, dict(mode="smooth")),
    "options": (20, 20, 400, 4, 1, dict(perceptual_weight=0.7,
                                        saturation_bias=0.5, pre_quantize=1,
                                        min_bucket_fraction=0.01)),
    "lab": (16, 12, 250, 5, 0, dict(use_lab=True)),
    "few colours": (8, 8, 5, 6, 0, {}),
    "import size bpp8": (64, 64, 5000, 7, 1, {}),
    "import size bpp4 smooth lab": (64, 64, 5000, 8, 0,
                                    dict(mode="smooth", use_lab=True)),
}


@pytest.mark.parametrize("case", sorted(QUANTIZE_CASES))
def test_quantize_matches_jax(case):
    w, h, ncol, seed, depth, kw = QUANTIZE_CASES[case]
    img = random_image(w, h, ncol, seed)
    ours = tq.quantize_image(img, w, h, depth=depth, name=case,
                             opts=tq.QuantizeOptions(**kw))
    theirs = jq.quantize_image(img, w, h, depth=depth, name=case,
                               opts=jq.QuantizeOptions(**kw))
    assert ours.clut.colors == theirs.clut.colors
    assert (ours.clut.depth, ours.clut.name) == (theirs.clut.depth,
                                                 theirs.clut.name)
    t, j = ours.texture, theirs.texture
    assert (t.width, t.height, t.depth) == (j.width, j.height, j.depth)
    assert t.indices.dtype == j.indices.dtype
    np.testing.assert_array_equal(t.indices, j.indices)
    assert len(set(t.indices.tolist())) > 1
    if not kw.get("use_lab"):
        gidx, gclut = gold.quantize_image(img, w, h, tq.depth_colors(depth),
                                          gold.default_opts(**kw))
        assert ours.clut.colors == gclut
        np.testing.assert_array_equal(t.indices, np.asarray(gidx, np.uint8))


def test_quantize_helpers_match_jax():
    rng = np.random.default_rng(11)
    rgb = rng.integers(0, 256, (500, 3), dtype=np.uint8)
    lab = tq.rgb888_to_lab(rgb)
    np.testing.assert_array_equal(lab, jq.rgb888_to_lab(rgb))
    np.testing.assert_array_equal(tq.lab_to_rgb888(lab),
                                  jq.lab_to_rgb888(lab))
    c15 = rng.integers(0, 1 << 15, 300).astype(np.uint16)
    np.testing.assert_array_equal(tq.color15_to_lab(c15),
                                  jq.color15_to_lab(c15))
    for kw in ({}, dict(mode="smooth"), dict(saturation_bias=0.4)):
        for k in (3, 15, 255):
            a = tq.median_cut(c15, k, 400, tq.QuantizeOptions(**kw))
            b = jq.median_cut(c15, k, 400, jq.QuantizeOptions(**kw))
            assert list(map(int, a)) == list(map(int, b))
            for pw in (0.0, 0.6):
                np.testing.assert_array_equal(
                    tq.nearest_in_palette(c15, list(a), pw),
                    jq.nearest_in_palette(c15, list(b), pw))
    for img in (random_image(10, 10, 8, 6, False), random_image(9, 7, 40, 2),
                np.zeros((4, 4, 4), np.uint8)):
        n = tq.count_unique_colors(img)
        assert n == jq.count_unique_colors(img)
        assert tq.optimal_clut_depth(n) == jq.optimal_clut_depth(n)
    assert tq.TRANSPARENT15 == jq.TRANSPARENT15
    assert [tq.depth_colors(d) for d in (0, 1)] == \
        [jq.depth_colors(d) for d in (0, 1)]


# ---------------------------------------------------------------------------
# Paint tools
# ---------------------------------------------------------------------------

def _paint_run(tex_pkg, user_texture, seed, steps=80, size=24):
    rng = random.Random(seed)
    tex = user_texture(id=1, name="t", width=size, height=size, depth=0,
                       indices=np.zeros(size * size, np.uint8),
                       palette=[0] + [0x7FFF - 40 * i for i in range(15)])
    state = tex_pkg.PaintState()
    trace = [tuple((t.uses_brush_size(), t.is_shape_tool(),
                    t.modifies_texture()) for t in tex_pkg.DrawTool)]
    sel = None

    def xy():
        return rng.randint(-3, size + 2), rng.randint(-3, size + 2)

    for _ in range(steps):
        op = rng.choice(("brush", "brush", "fill", "line", "rect",
                         "ellipse", "select", "selection", "undo", "redo",
                         "eyedrop", "palette"))
        idx = rng.randint(0, 15)
        if op in ("brush", "fill", "line", "rect", "ellipse", "palette"):
            state.save_undo(tex, op)
        if op == "brush":
            shape = rng.choice(list(tex_pkg.BrushShape))
            mask = (None if sel is None or rng.random() < 0.5
                    else tex_pkg.select_by_color(tex, *xy()))
            out = tex_pkg.paint_brush(tex, *xy(), idx, rng.randint(1, 6),
                                      shape, mask)
        elif op == "fill":
            out = tex_pkg.flood_fill(tex, *xy(), idx)
        elif op == "line":
            out = tex_pkg.draw_line(tex, *xy(), *xy(), idx,
                                    rng.randint(1, 4),
                                    rng.choice(list(tex_pkg.BrushShape)))
        elif op == "rect":
            out = tex_pkg.draw_rect(tex, *xy(), *xy(), idx,
                                    filled=rng.random() < 0.5)
        elif op == "ellipse":
            out = tex_pkg.draw_ellipse(tex, *xy(), *xy(), idx,
                                       filled=rng.random() < 0.5)
        elif op == "select":
            x, y = rng.randint(0, size - 1), rng.randint(0, size - 1)
            m = tex_pkg.select_by_color(tex, x, y,
                                        tolerance=rng.randint(0, 2),
                                        contiguous=rng.random() < 0.5)
            sel = tex_pkg.Selection.from_mask(m, size, size)
            out = uc.plain(m)
        elif op == "selection":
            inside = sel is not None and 0 <= sel.x and 0 <= sel.y \
                and sel.x + sel.w <= size and sel.y + sel.h <= size
            if not inside or rng.random() < 0.3:     # cut inside the canvas
                sel = tex_pkg.Selection.from_corners(
                    *(rng.randint(0, size - 1) for _ in range(4)))
            sel.cut(tex, background=rng.randint(0, 3))
            sel.x, sel.y = xy()                     # stamps clip
            sel.stamp(tex)
            out = (sel.is_rectangular(), sel.contains(*xy()),
                   sel.mask_at(1, 1))
        elif op == "undo":
            out = state.undo(tex)
        elif op == "redo":
            out = state.redo(tex)
        elif op == "eyedrop":
            x, y = rng.randint(0, size - 1), rng.randint(0, size - 1)
            out = state.eyedrop(tex, x, y)
        else:
            tex.palette[rng.randint(1, 15)] = rng.randint(0, 0x7FFF)
            out = None
        trace.append((op, uc.plain(out), uc.plain(sel),
                      tex.indices.tobytes(), list(tex.palette)))
    return trace


@pytest.mark.parametrize("seed", range(3))
def test_paint_script_matches_jax(seed):
    ours = _paint_run(ttex, UserTexture, seed)
    theirs = _paint_run(jtex, JUserTexture, seed)
    assert len(ours) == len(theirs)
    for k, (a, b) in enumerate(zip(ours, theirs)):
        assert a == b, f"step {k}: {a[0]}"
    assert len({t[3] for t in ours[1:]}) > 20      # the texture changed


# ---------------------------------------------------------------------------
# The import dialog
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["FIT_PAD", "STRETCH", "CROP_CENTER"])
@pytest.mark.parametrize("shape", [(80, 96), (96, 80), (30, 30)])
def test_resize_matches_jax(mode, shape):
    rgba = uc.import_rgba(2, shape)
    for target in (16, 64):
        a = ttex.resize_to_target(rgba, target, ttex.ResizeMode[mode])
        b = jtex.resize_to_target(rgba, target, jtex.ResizeMode[mode])
        assert a.shape == (target, target, 4) and a.dtype == np.uint8
        np.testing.assert_array_equal(a, b)
    assert ttex.ResizeMode[mode].label == jtex.ResizeMode[mode].label


def test_atlas_and_crop_match_jax():
    rgba = uc.import_rgba(3, (96, 160))
    for cell in ttex.ATLAS_CELL_SIZES:
        dims = ttex.atlas_dimensions(160, 96, cell)
        assert dims == jtex.atlas_dimensions(160, 96, cell)
        for col, row in ((0, 0), (dims[0] - 1, dims[1] - 1), (dims[0], 0)):
            a = ttex.extract_atlas_cell(rgba, cell, col, row)
            b = jtex.extract_atlas_cell(rgba, cell, col, row)
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)
    for sel in ((4, 2, 8, 6), (100, 50, 60, 46), (0, 0, 160, 96)):
        np.testing.assert_array_equal(ttex.extract_selection(rgba, sel),
                                      jtex.extract_selection(rgba, sel))
    assert ttex.IMPORT_SIZES == jtex.IMPORT_SIZES
    assert ttex.ATLAS_CELL_SIZES == jtex.ATLAS_CELL_SIZES
    assert [e.value for e in ttex.CropResizeEdge] == \
        [e.value for e in jtex.CropResizeEdge]


def _dialog(tex_pkg, png, depth, variant):
    st = tex_pkg.TextureImportState()
    st.load_png(png)
    out = [st.active, st.unique_colors, st.depth, st.source_width,
           st.source_height, st.preview_dirty]
    st.depth = depth
    if variant == "atlas":
        st.atlas_mode, st.atlas_cell_size = True, 32
        st.atlas_selected = (1, 1)
        st.target_size = 32
    elif variant == "crop":
        st.crop_selection = (10, 6, 50, 40)
        st.resize_mode = tex_pkg.ResizeMode.CROP_CENTER
        st.target_size = 32
    st.generate_preview()
    tex = st.finalize(7, f"imported {variant}")
    out += [st.source_for_preview().tobytes(), st.preview_indices.tobytes(),
            list(st.preview_palette), tex.id, tex.name, tex.width,
            tex.height, tex.depth, tex.indices.tobytes(), list(tex.palette),
            tex.to_texture15().tobytes()]
    st.reset()
    out += [st.active, st.source_rgba is None, st.preview_indices is None]
    return out


@pytest.mark.parametrize("variant", ["whole", "atlas", "crop"])
@pytest.mark.parametrize("depth", [0, 1])
def test_import_dialog_matches_jax(depth, variant, tmp_path):
    png = tmp_path / "import.png"
    Image.fromarray(uc.import_rgba(4), "RGBA").save(png)
    ours = _dialog(ttex, str(png), depth, variant)
    theirs = _dialog(jtex, str(png), depth, variant)
    assert ours == theirs
    assert ours[1] > 15 and ours[2] == 1       # auto depth picked 8 bpp


@pytest.mark.parametrize("depth", [0, 1])
def test_imported_texture_matches_jax(depth):
    """The seeded 96x80 image of chip_smoke's import check."""
    rgba = uc.import_rgba(0)
    st, tex = uc.imported_texture(ttex, rgba, depth)
    jst, jtx = uc.imported_texture(jtex, rgba, depth)
    assert (tex.width, tex.height, tex.depth) == (64, 64, depth)
    assert len(tex.palette) == (16, 256)[depth] and tex.palette[0] == 0
    np.testing.assert_array_equal(tex.indices, jtx.indices)
    assert tex.palette == jtx.palette
    np.testing.assert_array_equal(tex.to_texture15(), jtx.to_texture15())
    assert (tex.indices == 0).mean() > 0.1            # transparent texels
    assert (tex.to_texture15()[tex.indices.reshape(64, 64) == 0] == 0).all()


# ---------------------------------------------------------------------------
# The slice as a whole
# ---------------------------------------------------------------------------

def _seam_budget(npixels, n_inst):
    """tests/test_raster_batch.py's budget on the CPU."""
    return max(64 * n_inst, npixels // 500)


def imported_textures(tex_pkg, depth):
    """ts.textures() with FLOOR replaced by the imported texture."""
    _, tex = uc.imported_texture(tex_pkg, uc.import_rgba(0), depth)
    out = ts.textures()
    out[ts.TEXTURE_NAMES.index("FLOOR")] = (tex.to_texture15(), 0)
    return out


@pytest.mark.parametrize("depth", [0, 1])
def test_imported_texture_on_the_main_path_matches_jax(depth):
    level, jlevel = ts.cave_size_level(TL), ts.cave_size_level(JL)
    textures = imported_textures(ttex, depth)
    fn, args = entry.entry(level, n=N, device="cpu", textures=textures,
                           resolve=ts.resolver, height=H, width=W)
    assert rollout.kernel_route(args[1], RasterSettings.game())
    color = fn(*args).color.numpy()
    fn0, args0 = entry.entry(level, n=N, device="cpu",
                             textures=ts.textures(), resolve=ts.resolver,
                             height=H, width=W)
    changed = int((fn0(*args0).color.numpy() != color).sum())
    assert changed > color.size // 10, changed    # the floor shows it

    jenv = jrollout.build_env(jlevel, imported_textures(jtex, depth),
                              ts.resolver, flat=True)
    jstates = jrollout.initial_states(jlevel, ts.spawn_point(jlevel), N)
    jacts = jstep.Actions(
        move_x=jnp.full(N, 0.5, jnp.float32),
        move_y=jnp.full(N, 0.5, jnp.float32),
        cam_x=jnp.zeros(N, jnp.float32), cam_y=jnp.zeros(N, jnp.float32),
        sprint=jnp.zeros(N, bool), jump=jnp.zeros(N, bool))
    _, jfbs = jrollout.step_and_render(jstates, jenv, jacts,
                                       JRasterSettings.game(), height=H,
                                       width=W)
    jcolor = np.asarray(jfbs.color)
    diff = int((color != jcolor).sum())
    budget = _seam_budget(jcolor.size, N)
    print(f"imported texture at {depth}: {diff} of {jcolor.size} pixels "
          f"differ (budget {budget}); {changed} differ from the frame with "
          f"the checker floor")
    assert diff <= budget
