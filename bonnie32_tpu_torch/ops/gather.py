"""Table gather (bonnie32_tpu/ops/gather_pallas.py `select_gather`).

`select_gather(table, idx)` returns `table[clip(idx, 0, A - 1)]` in the
shape of `idx`, for a 1-D i32 or f32 table of A entries.  The JAX
package documents out-of-range indices as returning arbitrary in-range
data; its kernel clips them, and so does this one.  For CUDA tensors it
is the hand-written kernel of csrc/gather.cu (one thread an index; the
TPU's loop over 128-lane groups is how that machine gathers and is not
reproduced), for CPU tensors the plain twin `select_gather_ref`.
"""

import torch

_DTYPES = (torch.int32, torch.float32)


def select_gather_ref(table: torch.Tensor, idx: torch.Tensor):
    """Plain torch twin of the `select_gather` kernel."""
    return table[idx.long().clamp(0, table.shape[0] - 1)]


def _validate(table, idx):
    if table.dim() != 1 or table.shape[0] == 0:
        raise ValueError(f"table: expected a non-empty 1-D tensor, got "
                         f"shape {tuple(table.shape)}")
    if table.dtype not in _DTYPES:
        raise ValueError(f"table: expected int32 or float32, got "
                         f"{table.dtype}")
    if idx.dtype != torch.int32:
        raise ValueError(f"idx: expected int32, got {idx.dtype}")
    if idx.device != table.device:
        raise ValueError(f"idx on {idx.device}, table on {table.device}")


def select_gather(table: torch.Tensor, idx: torch.Tensor):
    """out[...] = table[clip(idx[...], 0, A - 1)]: the CUDA kernel for
    CUDA tensors, the plain twin for CPU tensors."""
    _validate(table, idx)
    if not table.is_cuda:
        if table.device.type != "cpu":
            raise ValueError(f"unsupported device {table.device}")
        return select_gather_ref(table, idx)
    from . import _cuda
    lib = _cuda.load("gather")
    dev = table.device
    if not table.is_contiguous() or not idx.is_contiguous():
        raise ValueError("table and idx must be contiguous")
    out = torch.empty(idx.shape, dtype=table.dtype, device=dev)
    if idx.numel() == 0:
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.select_gather(table.data_ptr(), idx.data_ptr(), out.data_ptr(),
                            idx.numel(), table.shape[0], stream)
    if err != 0:
        raise RuntimeError(f"select_gather launch failed: CUDA error {err}")
    select_gather.launches += 1
    return out


select_gather.launches = 0
