"""The JAX package's references for the tests of the port's sequential
renderer: render_mesh_15 of tests/torch_render_cases.py's configurations,
compile_level / render_level of tests/torch_seq_cases.py's levels and one
frame of rollout.step_and_render.  Each render_mesh_15 reference is
computed once per process."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import scenes
import torch_render_cases as rc
import torch_scenes as ts
from bonnie32_tpu import config as jc
from bonnie32_tpu import rollout as jrollout
from bonnie32_tpu.game import step as jstep
from bonnie32_tpu.models import asset as JA
from bonnie32_tpu.models import build as jbuild
from bonnie32_tpu.models import level as JL
from bonnie32_tpu.models import mesh as JM
from bonnie32_tpu.models import scene as JS
from bonnie32_tpu.models import user_texture as JU
from bonnie32_tpu.ops import raster_ref as jrr
from bonnie32_tpu.render import render_mesh_15
from bonnie32_tpu.types import no_fog
from bonnie32_tpu_torch import interop
from bonnie32_tpu_torch import rollout as trollout
from bonnie32_tpu_torch.game import step as tstep
from bonnie32_tpu_torch.models import scene as tscene
from torch_seq_cases import H, POSES, W, level_args

JAX_MODULES = dict(L=JL, A=JA, M=JM, U=JU, S=JS)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_settings(settings):
    """The JAX package's RasterSettings equal to the port's `settings`."""
    o = settings.ortho_projection
    return jc.RasterSettings(**{
        f.name: getattr(settings, f.name)
        for f in dataclasses.fields(settings)
        if f.name not in ("shading", "ortho_projection")},
        shading=jc.ShadingMode(int(settings.shading)),
        ortho_projection=None if o is None else jc.OrthoProjection(
            o.zoom, o.center_x, o.center_y))


_FRAMES = {}


def jax_frame(name, mode):
    """The JAX package's render_mesh_15 of a render case (XLA:CPU),
    computed once: (H, W) i32 words."""
    key = (name, mode)
    if key not in _FRAMES:
        scene, settings, fog, _ = rc.CONFIGS[name]
        verts, faces, tex = scene()
        mesh, fa = scenes.to_jax_scene(verts, faces)
        campos, basis = rc.camera_of(name)
        fb = jrr.new_framebuffer(rc.H, rc.W, rc.clear_mode(settings, mode))
        out = render_mesh_15(
            fb, mesh, fa, jbuild.build_atlas(tex),
            jbuild.make_camera(campos, basis),
            jbuild.lights_from_list(rc.light_specs_of(name),
                                    ambient=settings.ambient),
            no_fog() if fog is None else scenes.make_fog(*fog),
            jax_settings(settings), depth_mode=mode)
        _FRAMES[key] = np.asarray(out.color)
    return _FRAMES[key]


def compile_both(name):
    """(JAX CompiledScene with numpy leaves, the port's on the CPU)."""
    jlevel, tex, kw, _ = level_args(name, **JAX_MODULES)
    jsc = JS.compile_level(jlevel, tex, ts.resolver, **kw)
    tlevel, tex, kw, _ = level_args(name)
    tsc = tscene.compile_level(tlevel, tex, ts.resolver, device="cpu", **kw)
    return _np(jsc), tsc


def jax_cams(key):
    cams = [jbuild.make_camera(np.asarray(p, np.float32),
                               jbuild.camera_basis(pi, ya))
            for p, pi, ya in POSES[key]]
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *cams)


def jax_render_level(name, settings, clear="inv", **kw):
    """The JAX render_level of the level's POSES cameras on frames
    cleared with `clear` depth: (cameras with numpy leaves, colour
    (N, H, W))."""
    jlevel, tex, ckw, key = level_args(name, **JAX_MODULES)
    jsc = JS.compile_level(jlevel, tex, ts.resolver, **ckw)
    cams = jax_cams(key)
    fb0 = jrr.new_framebuffer(H, W, depth_mode=clear)
    js = jax_settings(settings)
    color = jax.vmap(lambda c: JS.render_level(fb0, jsc, c, js,
                                               **kw).color)(cams)
    return _np(cams), np.asarray(color)


def rollout_pair(name, settings, n=3, seed=7, flat_jax=False):
    """One frame of both packages' rollout.step_and_render on a test
    level from the same states and numpy-seeded actions: the JAX env
    built with flat=`flat_jax`, the port's with its default (flat=True),
    so that the port routes by the settings.  Returns a dict with the
    port's env, the JAX cameras (numpy leaves), both packages' frames
    (colour (n, H, W)) and new states."""
    jlevel, tex, kw, _ = level_args(name, **JAX_MODULES)
    jenv = jrollout.build_env(jlevel, tex, ts.resolver, flat=flat_jax, **kw)
    tlevel, tex, kw, _ = level_args(name)
    tenv = trollout.build_env(tlevel, tex, ts.resolver, device="cpu", **kw)
    jstates = jrollout.initial_states(jlevel, ts.spawn_point(jlevel), n)
    tstates = interop.game_state(_np(jstates))
    acts = ts.actions_np(np.random.default_rng(seed), n)
    jstates, jfb = jrollout.step_and_render(
        jstates, jenv, jstep.Actions(**{k: jnp.asarray(v)
                                        for k, v in acts.items()}),
        jax_settings(settings), height=H, width=W, instance_chunk=None)
    jcams = jax.vmap(lambda s: jstep.character_camera(s, jenv.params))(
        jstates)
    tstates, tfb = trollout.step_and_render(
        tstates, tenv, tstep.Actions(**{k: torch.from_numpy(v)
                                        for k, v in acts.items()}),
        settings, height=H, width=W)
    return dict(tenv=tenv, jcams=_np(jcams), jcolor=np.asarray(jfb.color),
                jstates=_np(jstates), tcolor=tfb.color.numpy(),
                tstates=tstates)
