"""The port's drag tracker (ui/drag_tracker.py) against the JAX package's,
on the CPU: the line, plane, circle and screen pickers, each unsnapped,
relatively and absolutely snapped to a grid (tests/torch_ui_cases.py
`drag_cases`), along seeded mouse paths from three seeded cameras.  After
every move the current position and angle, the position, angle and mouse
deltas, and after `reset_initial` the re-anchored state.

Tolerance: unsnapped positions and angles within rtol 1e-5 / atol 1e-4,
the bound of tests/test_torch_picking.py (XLA:CPU may contract the JAX
package's ray arithmetic into FMAs); snapped positions and angles, which
land on a grid, and the mouse deltas (host floats) exactly.  The same
drags with the camera as torch tensors (the device path: the ray queries
run on the basis's device) equal the numpy camera's bit for bit.
"""

import numpy as np
import pytest
import torch

import torch_ui_cases as uc
from bonnie32_tpu import ui as jui
from bonnie32_tpu_torch import ui as tui

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-4
SEEDS = range(3)


@pytest.fixture(scope="module")
def jax_drags():
    return {seed: uc.run_drags(jui, *uc.drag_camera(seed), seed)
            for seed in SEEDS}


@pytest.mark.parametrize("seed", SEEDS)
def test_drags_match_jax(seed, jax_drags):
    ours = uc.run_drags(tui, *uc.drag_camera(seed), seed)
    theirs = jax_drags[seed]
    assert [c[:2] for c in ours] == [c[:2] for c in theirs]
    worst = 0.0
    for (name, snap, moves), (_, _, jmoves) in zip(ours, theirs):
        for k, (a, b) in enumerate(zip(moves, jmoves)):
            pos, ang, dpos, dang, dmouse = a
            assert pos.dtype == np.float32 and dpos.dtype == np.float32
            assert dmouse == b[4], (name, k)
            if snap == "none":
                np.testing.assert_allclose(pos, b[0], rtol=RTOL, atol=ATOL,
                                           err_msg=f"{name} move {k}")
                np.testing.assert_allclose([ang, dang], [b[1], b[3]],
                                           rtol=RTOL, atol=ATOL)
                np.testing.assert_allclose(dpos, b[2], rtol=RTOL, atol=ATOL)
                worst = max(worst, float(np.abs(pos - b[0]).max()),
                            abs(ang - b[1]))
            else:
                np.testing.assert_array_equal(pos, b[0], f"{name} move {k}")
                np.testing.assert_array_equal(dpos, b[2])
                assert (ang, dang) == (b[1], b[3]), (name, k)
    print(f"seed {seed}: largest unsnapped difference {worst:.3g}")


@pytest.mark.parametrize("seed", SEEDS)
def test_drags_move_and_snap(seed):
    """The paths reach every picker: positions or angles change, and the
    snapped ones land on their grid."""
    ours = uc.run_drags(tui, *uc.drag_camera(seed), seed)
    grids = {"line": 64.0, "plane": 32.0, "circle": np.pi / 12,
             "screen": 16.0}
    for name, snap, moves in ours:
        picker = name.split(",")[0]
        states = {(tuple(m[0]), m[1]) for m in moves[:-1]}
        assert len(states) >= 2, name
        if snap == "absolute":
            g = grids[picker]
            if picker == "circle":
                vals = np.asarray([m[1] for m in moves[:-1]]) / g
            elif picker == "line":
                continue     # snaps the line parameter, not the position
            else:
                vals = np.concatenate([m[0] for m in moves[:-1]]) / g
            np.testing.assert_allclose(vals, np.round(vals), atol=1e-5)
        assert moves[-1][4] == (0.0, 0.0) and moves[-1][3] == 0.0


@pytest.mark.parametrize("seed", SEEDS)
def test_tensor_camera_equals_numpy_camera(seed):
    pos, basis = uc.drag_camera(seed)
    ours = uc.run_drags(tui, pos, basis, seed)
    tens = uc.run_drags(tui, torch.from_numpy(pos), torch.from_numpy(basis),
                        seed)
    for (name, _, a), (_, _, b) in zip(ours, tens):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x[0], y[0], name)
            assert x[1:2] + x[3:] == y[1:2] + y[3:], name


def test_drag_state_helpers_match_jax():
    def run(ui):
        st = ui.DragState.new([1, 2, 3], [0.5, 0, 0], (10, 20))
        st.current_position = st.current_position + np.float32(2.0)
        st.current_mouse = (15.0, 12.0)
        out = [uc.plain(st.position_delta()), st.mouse_delta()]
        st.reset_initial()
        out += [uc.plain(st.initial_position), st.mouse_delta()]
        rot = ui.DragState.new_rotation([0, 0, 0], 0.5, (1, 2), (3, 4),
                                        camera=("c",), viewport=(320, 240))
        rot.current_angle = 1.25
        out += [rot.angle_delta(), rot.center_screen, rot.start_viewport,
                uc.plain(ui.DragConfig.line([0, 0, 0], [1, 0, 0])
                         .with_snap(0.5)),
                uc.plain(ui.DragConfig.plane([0, 1, 0], [0, 1, 0])
                         .with_absolute_snap(2.0))]
        cfg = ui.DragConfig(snap_mode="relative", grid_size=0.25)
        out += [cfg._snap_scalar(1.13, 0.1), cfg._snap_scalar(-0.4, 0.0)]
        return out
    assert run(tui) == run(jui)
