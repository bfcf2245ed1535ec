"""The port's batch.render_batch (bonnie32_tpu_torch/batch.py) on the
CPU: every instance of a batch equals render_mesh_15 of that instance
alone, pixel for pixel (the JAX package allows seam pixels there only
because XLA:CPU compiles the two programs apart), in each depth mode and
whatever the instance chunk; distinct cameras give distinct frames."""

import numpy as np
import pytest
import torch

import torch_render_cases as rc
import torch_scenes as ts
from bonnie32_tpu_torch import batch, render, types
from bonnie32_tpu_torch.config import RasterSettings
from bonnie32_tpu_torch.models import build
from bonnie32_tpu_torch.ops import raster_ref

torch.set_num_threads(1)
H, W = 60, 80


def _scene():
    verts, faces = ts.cube_scene(tex_ids=(0, 0, 0, None, None, 0))
    mesh, fa = rc.torch_mesh(verts, faces)
    atlas = build.build_atlas([ts.checker_texture15(16, 16,
                                                    with_black=True)])
    return mesh, fa, atlas, build.lights_from_list(ts.DEFAULT_LIGHT_SPECS)


def _cameras(n):
    """Orbit cameras 3.5 units behind the cube (tests/test_batch.py's)."""
    pos, bas = [], []
    for i in range(n):
        basis = build.camera_basis(0.3, 0.3 + 0.4 * i)
        pos.append((-3.5 * basis[2]).astype(np.float32))
        bas.append(basis)
    return batch.batched_cameras(np.stack(pos), np.stack(bas), device="cpu")


@pytest.mark.parametrize("chunk", [None, 2, 3])
@pytest.mark.parametrize("mode", rc.MODES)
def test_batch_matches_single(mode, chunk):
    mesh, fa, atlas, lights = _scene()
    settings = RasterSettings.game()
    n = 5
    cams = _cameras(n)
    fbs = batch.batched_framebuffers(n, H, W, depth_mode=mode,
                                     device="cpu")
    out = batch.render_batch(fbs, mesh, fa, atlas, cams, lights,
                             types.no_fog(device="cpu"), settings,
                             depth_mode=mode, instance_chunk=chunk)
    assert out.color.shape == (n, H, W)
    for i in range(n):
        fb1 = raster_ref.new_framebuffer(
            H, W, depth_mode="inv" if mode == "fast" else mode,
            device="cpu")
        cam1 = types.CameraArrays(cams.position[i:i + 1],
                                  cams.basis[i:i + 1])
        single = render.render_mesh_15(fb1, mesh, fa, atlas, cam1, lights,
                                       types.no_fog(device="cpu"), settings,
                                       depth_mode=mode)
        assert torch.equal(out.color[i], single.color[0]), i
        assert torch.equal(out.depth[i], single.depth[0]), i
    assert not torch.equal(out.color[0], out.color[1])
    assert ((out.color >> 24) & 255 == 255).any()


def test_batched_framebuffers_clear():
    fb = batch.batched_framebuffers(3, 4, 5, depth_mode="harmonic",
                                    clear_color=raster_ref.clear_color_word(
                                        10, 20, 30), device="cpu")
    assert fb.color.shape == (3, 4, 5)
    assert int(fb.color[0, 0, 0]) == raster_ref.clear_color_word(
        10, 20, 30) - (1 << 32)
    assert float(fb.depth.min()) == raster_ref.F32_MAX
    fast = batch.batched_framebuffers(2, 4, 5, device="cpu")
    assert float(fast.depth.abs().max()) == 0.0
