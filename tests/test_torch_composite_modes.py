"""The cube's x-ray and painter's cases and its unshaded case, port vs
JAX (see test_torch_composite.py for the cases and tolerances).
"""

import pytest

from test_torch_composite import check_cube, cube_refs

CUBE_HERE = ("none", "xray", "painters")


@pytest.fixture(scope="module")
def cube():
    return cube_refs(CUBE_HERE)


@pytest.mark.parametrize("name", CUBE_HERE)
def test_cube_matches_jax(cube, name):
    check_cube(cube, name)
