"""`ops/gather.select_gather` of the port vs numpy and vs the JAX
package's Pallas gather (ops/gather_pallas.py).

Inputs come from a numpy seed; every comparison is exact (a gather moves
words).  The JAX reference is the package's own kernel body `_kernel`,
run in interpret mode on the CPU from this test's own `pallas_call`,
with the table padding and index clipping of `select_gather` repeated
here: `select_gather` itself pins its operands to TPU VMEM and takes no
interpret flag, so it cannot run on the CPU.  On the CPU the port's
wrapper runs its plain twin; the CUDA kernel is held against the twin in
tests/test_torch_gpu.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from bonnie32_tpu.ops import gather_pallas as gp
from bonnie32_tpu_torch.ops import gather as tg

torch.set_num_threads(1)

CASES = {
    "i32_small": (np.int32, 300, (7, 33)),
    "f32_small": (np.float32, 129, (5, 64)),
    "i32_one_group": (np.int32, 128, (256,)),
    "f32_32k": (np.float32, 32768, (3, 40, 50)),
    "i32_single_entry": (np.int32, 1, (17,)),
}


def _inputs(case):
    dtype, size, shape = CASES[case]
    rng = np.random.default_rng(size)
    if dtype == np.int32:
        table = rng.integers(-2 ** 31, 2 ** 31, size, dtype=np.int64).astype(
            np.int32)
    else:
        table = rng.standard_normal(size).astype(np.float32)
    # a tenth of the indices out of range, on both sides
    idx = rng.integers(-size // 10 - 3, size + size // 10 + 3, shape).astype(
        np.int32)
    return table, idx


def _jax_kernel_interpret(table, idx):
    """gather_pallas.select_gather's wrapper around `_kernel`, with
    interpret=True in place of the VMEM block specs."""
    a = table.shape[0]
    groups = -(-a // gp._LANES)
    table2 = jnp.zeros((groups * gp._LANES,), table.dtype).at[:a].set(table)
    table2 = table2.reshape(groups, gp._LANES)
    n = idx.size
    rows = -(-n // gp._LANES)
    pad_rows = -(-rows // 8) * 8
    flat = jnp.zeros((pad_rows * gp._LANES,), jnp.int32).at[:n].set(
        jnp.asarray(idx).reshape(-1))
    flat = jnp.clip(flat, 0, a - 1).reshape(pad_rows, gp._LANES)
    out = pl.pallas_call(
        functools.partial(gp._kernel, groups=groups),
        out_shape=jax.ShapeDtypeStruct((pad_rows, gp._LANES), table.dtype),
        interpret=True)(table2, flat)
    return np.asarray(out).reshape(-1)[:n].reshape(idx.shape)


@pytest.mark.parametrize("case", sorted(CASES))
def test_select_gather_matches_numpy(case):
    table, idx = _inputs(case)
    assert (idx < 0).any() and (idx >= table.shape[0]).any()
    out = tg.select_gather(torch.from_numpy(table), torch.from_numpy(idx))
    assert out.shape == idx.shape and out.dtype == torch.from_numpy(
        table).dtype
    want = table[np.clip(idx, 0, table.shape[0] - 1)]
    np.testing.assert_array_equal(out.numpy(), want)


@pytest.mark.parametrize("case", ["i32_small", "f32_small",
                                  "i32_one_group"])
def test_select_gather_matches_jax_kernel(case):
    table, idx = _inputs(case)
    theirs = _jax_kernel_interpret(jnp.asarray(table), idx)
    ours = tg.select_gather(torch.from_numpy(table), torch.from_numpy(idx))
    np.testing.assert_array_equal(ours.numpy(), theirs)


def test_select_gather_empty_index():
    out = tg.select_gather(torch.arange(4, dtype=torch.int32),
                           torch.zeros((0, 3), dtype=torch.int32))
    assert out.shape == (0, 3)


@pytest.mark.parametrize("bad", ["dtype", "idx_dtype", "rank", "empty"])
def test_select_gather_rejects(bad):
    table = torch.arange(8, dtype=torch.int32)
    idx = torch.zeros(4, dtype=torch.int32)
    if bad == "dtype":
        table = table.to(torch.int64)
    elif bad == "idx_dtype":
        idx = idx.long()
    elif bad == "rank":
        table = table.reshape(2, 4)
    else:
        table = table[:0]
    with pytest.raises(ValueError):
        tg.select_gather(table, idx)
