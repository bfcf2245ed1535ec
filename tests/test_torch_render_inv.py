"""The port's render_mesh_15 against the JAX package's in "inv" depth
mode on test_raster_parity.py's configurations, within that file's seam
budget (XLA:CPU contracts FMAs; the port does not).  A file of its own so
that the test workers compute the JAX references in parallel
(test_torch_render.py holds the golden model and the "fast" mode)."""

import pytest
import torch

import jax_refs
import torch_render_cases as rc

torch.set_num_threads(1)


@pytest.mark.parametrize("name", sorted(rc.CONFIGS))
def test_render_mesh_15_matches_jax_inv(name):
    ours = rc.port_frame(name, "inv")
    theirs = jax_refs.jax_frame(name, "inv")
    diff = int((ours != theirs).sum())
    assert diff <= rc.seam_budget(ours.size), diff
