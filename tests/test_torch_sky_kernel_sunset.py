"""The sunset sky's cases of test_torch_sky_kernel.py (tint, sun, haze,
two cloud layers, mountains; no stars), in a file of their own so that
another test worker compiles their JAX references."""

import pytest
import torch

from test_torch_sky_kernel import (ROUTES, check_cube_over_sky,
                                   check_port_routes_agree, cube_refs)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def refs():
    return cube_refs(("sunset_preset",))


@pytest.mark.parametrize("route", ROUTES)
def test_cube_over_sunset_sky_matches_jax(refs, route):
    check_cube_over_sky(refs, "sunset_preset", route)


def test_port_routes_agree_exactly_sunset(refs):
    check_port_routes_agree(refs, "sunset_preset")
