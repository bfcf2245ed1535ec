"""The port's profiling module (bonnie32_tpu_torch/profiling.py) on the
CPU: `raster_stats` against the JAX package's `raster_stats` and the
golden cull counts of tests/test_profiling.py (its helper copied, with
the camera as an argument), on the cube and on the Cave-size level
(tests/torch_scenes.py, its one room as a mesh; also its transparent
variant, so that both passes count), with and without
backface culling, for one camera (0-dim counters) and a batch of three
((3,) counters) — exact; the Profiler and FrameTimings cases of
test_profiling.py; `trace` writes a Chrome trace and `busy_share` lies in
[0, 1] (0 here: the CPU build traces no kernel).
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scenes
import torch_render_cases as rc
import torch_scenes as ts
from bonnie32_tpu import profiling as jprof
from bonnie32_tpu.config import RasterSettings as JRasterSettings
from bonnie32_tpu.models import build as jbuild
from bonnie32_tpu.models import level as JL
from bonnie32_tpu.types import no_fog as jno_fog
from bonnie32_tpu_torch import profiling
from bonnie32_tpu_torch.config import RasterSettings
from bonnie32_tpu_torch.models import build
from bonnie32_tpu_torch.types import CameraArrays, no_fog

torch.set_num_threads(1)
W, H = 160, 120
BASIS = build.camera_basis(0.35, 0.6)
CAMPOS = np.array([-1.8, -1.5, -3.2], np.float32)
# three cameras inside the Cave-size room: low and looking along it,
# high and looking down, in a corner looking at the pillars
CAVE_CAMS = [((1200.0, 1400.0, 900.0), (0.1, 0.8)),
             ((4096.0, 3600.0, 4096.0), (-0.9, 2.2)),
             ((7600.0, 1800.0, 7400.0), (0.05, -2.4))]


def _golden_counts(verts, faces, campos, basis, settings_kw):
    """Surfaces surviving the golden cull phase (render.rs:2545):
    tests/test_profiling.py's helper with the camera an argument."""
    gsettings = dict(backface_cull=True, xray_mode=False,
                     use_fixed_point=True)
    gsettings.update(settings_kw)
    from golden.raster_golden import NEAR_PLANE
    drawn = 0
    import golden.raster_golden as rg
    campos = np.asarray(campos, np.float32)
    bx, by, bz = [np.asarray(basis[i], np.float32) for i in range(3)]
    cams, projs = [], []
    for v in verts:
        rel = rg._sub3(np.asarray(v["pos"], np.float32), campos)
        cp = rg.perspective_transform(rel, bx, by, bz)
        cams.append(cp)
        if gsettings["use_fixed_point"]:
            from golden import fixed_golden as fxg
            sx, sy, _ = fxg.project_fixed(
                tuple(float(x) for x in v["pos"]),
                tuple(float(x) for x in campos),
                tuple(float(x) for x in bx), tuple(float(x) for x in by),
                tuple(float(x) for x in bz), W, H)
            projs.append(np.array([sx, sy, cp[2] + 5.0], np.float32))
        else:
            projs.append(rg.project(cp, W, H))
    for f in faces:
        cz = [cams[f["v0"]][2], cams[f["v1"]][2], cams[f["v2"]][2]]
        if min(cz) <= NEAR_PLANE:
            continue
        v1, v2, v3 = projs[f["v0"]], projs[f["v1"]], projs[f["v2"]]
        area = ((v2[0] - v1[0]) * (v3[1] - v1[1])
                - (v3[0] - v1[0]) * (v2[1] - v1[1]))
        if (area <= 0.0 and gsettings["backface_cull"]
                and not gsettings["xray_mode"]):
            continue
        drawn += 1
    return drawn


def _cube():
    tex = [ts.checker_texture15(16, 16)]
    verts, faces = ts.cube_scene(tex_ids=(0, 0, None, None, 0, 0))
    return verts, faces, tex, [(CAMPOS, BASIS)]


def _cave(transparent=False):
    level = (ts.transparent_cave_level(JL) if transparent
             else ts.cave_size_level(JL))
    verts, faces = level.rooms[0].to_render_data(ts.resolver)
    cams = [(np.array(p, np.float32), jbuild.camera_basis(*pb))
            for p, pb in CAVE_CAMS]
    return verts, faces, (ts.transparent_textures() if transparent
                          else ts.textures()), cams


SCENES = {"cube": _cube, "cave": _cave,
          "transparent_cave": lambda: _cave(transparent=True)}


@pytest.mark.parametrize("cull", [True, False])
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_raster_stats_match_jax_and_golden(scene, cull):
    verts, faces, tex, cams = SCENES[scene]()
    settings = RasterSettings.game(backface_cull=cull)
    jsettings = JRasterSettings.game(backface_cull=cull)
    specs = scenes.DEFAULT_LIGHT_SPECS
    mesh, fa = rc.torch_mesh(verts, faces)
    atlas = build.build_atlas(tex)
    lights = build.lights_from_list(specs, ambient=settings.ambient)
    jmesh, jfa = scenes.to_jax_scene(verts, faces)
    jatlas = jbuild.build_atlas(tex)
    jlights = jbuild.lights_from_list(specs, ambient=jsettings.ambient)
    batch = profiling.raster_stats(
        mesh, fa, atlas,
        CameraArrays(torch.from_numpy(np.stack([c[0] for c in cams])),
                     torch.from_numpy(np.stack([c[1] for c in cams]))),
        lights, no_fog(device="cpu"), settings, W, H)
    for i, (campos, basis) in enumerate(cams):
        one = profiling.raster_stats(
            mesh, fa, atlas, build.make_camera(campos, basis), lights,
            no_fog(device="cpu"), settings, W, H)
        want = jprof.raster_stats(
            jmesh, jfa, jatlas, jbuild.make_camera(campos, basis), jlights,
            jno_fog(), jsettings, W, H)
        gold = _golden_counts(verts, faces, campos, basis,
                              {"backface_cull": cull})
        print(f"{scene} camera {i}: " + ", ".join(
            f"{f} {int(v)}" for f, v in zip(one._fields, one)))
        for f in profiling.RasterStats._fields:
            v = getattr(one, f)
            assert v.shape == () and v.dtype == torch.int32, f
            assert int(v) == int(getattr(want, f)), f
            assert int(getattr(batch, f)[i]) == int(v), f
        assert int(one.triangles_drawn) == gold
        assert int(one.triangles_in) == len(faces)
        assert int(one.opaque_drawn) + int(one.transparent_drawn) == gold
        assert int(one.backfaces_culled) == len(faces) - gold
        assert 0 < gold <= len(faces)
        if not cull and scene == "cube":
            assert gold == len(faces)
    assert batch.triangles_drawn.shape == (len(cams),)
    if scene == "transparent_cave":
        assert int(batch.transparent_drawn.sum()) > 0


def test_profiler_phases():
    prof = profiling.Profiler()
    with prof.phase("a"):
        sum(range(1000))
    with prof.phase("a"):
        sum(range(1000))
    with prof.phase("b"):
        pass
    t = prof.timings
    assert t.counts["a"] == 2 and t.counts["b"] == 1
    assert t.ms["a"] >= 0.0
    assert t.total_ms == t.ms["a"] + t.ms["b"]
    assert "a" in prof.summary()

    other = profiling.FrameTimings()
    other.add("a", 0.001)
    t.accumulate(other)
    assert t.counts["a"] == 3

    got = prof.reset()
    assert got is t and prof.timings.ms == {}


def test_profiler_timed_device():
    prof = profiling.Profiler()
    out = prof.timed("matmul", lambda: torch.ones((64, 64)) @ torch.ones(
        (64, 64)))
    assert out.shape == (64, 64)
    assert prof.timings.ms["matmul"] > 0
    with prof.phase("sync", sync={"x": (out, None), "n": 3}):
        out = out + 1
    assert prof.timings.counts["sync"] == 1

    off = profiling.Profiler(enabled=False)
    off.timed("x", lambda: 1)
    with off.phase("y", sync=out):
        pass
    assert off.timings.ms == {}


def test_frame_timings_summary_matches_jax():
    ours, theirs = profiling.FrameTimings(), jprof.FrameTimings()
    for t in (ours, theirs):
        for phase, s in (("render", 0.0104), ("input", 0.0012),
                         ("render", 0.0098), ("ui", 0.0021)):
            t.add(phase, s)
    assert ours.summary() == theirs.summary()
    assert ours.ms == theirs.ms and ours.counts == theirs.counts


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = str(tmp_path / "trace")
    with profiling.trace(log_dir) as prof:
        x = torch.ones((128, 128))
        for _ in range(3):
            x = x @ x / 128.0
    path = os.path.join(log_dir, profiling.TRACE_FILE)
    with open(path) as f:
        doc = json.load(f)
    assert doc["traceEvents"]
    share = profiling.busy_share(prof)
    assert 0.0 <= share <= 1.0
    assert profiling.kernel_events(prof) == [] and share == 0.0
    assert any("mm" in e.name for e in prof.events())
    # the JAX package's trace writes into its directory too
    jdir = str(tmp_path / "jtrace")
    with jprof.trace(jdir):
        jnp.ones(8).sum().block_until_ready()
    assert os.listdir(jdir)
