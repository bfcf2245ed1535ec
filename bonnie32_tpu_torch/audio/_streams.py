"""What the two SPU recurrences (audio/reverb.py, audio/resampler.py)
share: the leading stream axis of their states and inputs, and the
launch of their kernels in csrc/audio.cu."""

import torch

_F32 = torch.float32


def batched(state, left, right):
    """`state` (a NamedTuple of tensors) and the inputs with a leading
    stream axis: left/right (N,) or (S, N), moved to the state's device
    as contiguous f32; where they are (N,), every state tensor gains a
    leading axis of 1 (a view: the kernels' in-place updates reach the
    caller's tensors).  Returns (state, left, right, single), `single`
    whether the inputs were (N,)."""
    dev = state[0].device
    left = torch.as_tensor(left, dtype=_F32, device=dev)
    right = torch.as_tensor(right, dtype=_F32, device=dev)
    if left.shape != right.shape or left.dim() not in (1, 2):
        raise ValueError(f"left {tuple(left.shape)} and right "
                         f"{tuple(right.shape)}: expected one (N,) or "
                         f"(S, N) shape")
    single = left.dim() == 1
    if single:
        state = type(state)(*(t[None] for t in state))
        left, right = left[None], right[None]
    if state[0].dim() == 0 or state[0].shape[0] != left.shape[0]:
        raise ValueError(f"{type(state).__name__} {tuple(state[0].shape)} "
                         f"does not hold {left.shape[0]} streams")
    return state, left.contiguous(), right.contiguous(), single


def unbatched(state, out_l, out_r, single: bool):
    """(state, out_l, out_r) with the leading axis `batched` added taken
    off again where the inputs were (N,)."""
    if single:
        return type(state)(*(t[0] for t in state)), out_l[0], out_r[0]
    return state, out_l, out_r


def launch(name: str, pointers, left, scalars):
    """Launch kernel `name` of csrc/audio.cu on the current stream of
    `left`'s card: the checked state and input `pointers`, then two
    outputs shaped like `left` (S, N) f32, S, N and the `scalars`.
    Raises on a CUDA error.  Returns (out_l, out_r)."""
    from ..ops import _cuda
    lib = _cuda.load("audio")
    streams, n = left.shape
    out_l = torch.empty_like(left)
    out_r = torch.empty_like(left)
    stream = torch.cuda.current_stream(left.device).cuda_stream
    err = getattr(lib, name)(*pointers, out_l.data_ptr(), out_r.data_ptr(),
                             streams, n, *scalars, stream)
    _cuda._raise_on(err, name)
    return out_l, out_r
