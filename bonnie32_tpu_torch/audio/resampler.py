"""PS1 SPU Gaussian resampler (the JAX package's `audio/resampler.py`).

The 4-tap Gaussian interpolation resampler of the reference's
`src/tracker/audio.rs:176-345`: downsample-by-averaging to the SPU pitch
rate, then re-interpolate at 44.1 kHz with the hardware's 512-entry
Gaussian ROM indexed by bits 4-11 of the pitch counter — the
characteristic warm/muffled PS1 sound.

A sequential recurrence per stream; streams are batched on a leading
axis as in audio/reverb.py.  `process` runs the hand-written kernel
`spu_resample` of csrc/audio.cu for CUDA tensors and the plain twin
`process_ref` for CPU tensors.
"""

from typing import NamedTuple, Tuple

import torch

from ..types import resolve_device
from . import _streams
from .spu_tables import GAUSSIAN_TABLE

_F32 = torch.float32
_I32 = torch.int32

PITCH_NATIVE = 0x1000
PITCH_22K = 0x0800
PITCH_11K = 0x0400
PITCH_5K = 0x0200


class ResamplerState(NamedTuple):
    history_l: torch.Tensor   # ([S,] 4) f32
    history_r: torch.Tensor   # ([S,] 4) f32
    pitch_counter: torch.Tensor  # ([S]) i32
    accum_l: torch.Tensor     # ([S]) f32
    accum_r: torch.Tensor     # ([S]) f32
    accum_count: torch.Tensor  # ([S]) i32


def init_state(device=None, streams=None) -> ResamplerState:
    """The silent state on `device` (default: the card): unbatched, or
    with a leading axis of `streams` independent streams."""
    dev = resolve_device(device)
    lead = () if streams is None else (int(streams),)
    return ResamplerState(
        history_l=torch.zeros(lead + (4,), dtype=_F32, device=dev),
        history_r=torch.zeros(lead + (4,), dtype=_F32, device=dev),
        pitch_counter=torch.zeros(lead, dtype=_I32, device=dev),
        accum_l=torch.zeros(lead, dtype=_F32, device=dev),
        accum_r=torch.zeros(lead, dtype=_F32, device=dev),
        accum_count=torch.zeros(lead, dtype=_I32, device=dev))


def _passes(pitch: int) -> bool:
    """A pitch outside (0, PITCH_NATIVE) leaves the signal as it is."""
    return not 0 < pitch < PITCH_NATIVE


def process_ref(state: ResamplerState, left, right, pitch: int,
                enabled=True) -> Tuple[ResamplerState, torch.Tensor,
                                       torch.Tensor]:
    """The plain twin of `spu_resample` (resampler.py:58-102 of the JAX
    package), a Python loop over samples, every stream at once.  Returns
    (new_state, left_out, right_out); `state` is not changed."""
    if _passes(pitch):
        dev = state.history_l.device
        return (state, torch.as_tensor(left, dtype=_F32, device=dev),
                torch.as_tensor(right, dtype=_F32, device=dev))
    state, left, right, single = _streams.batched(state, left, right)
    dev = left.device
    ratio = PITCH_NATIVE // pitch
    table = torch.tensor(GAUSSIAN_TABLE, dtype=_I32, device=dev)
    div = torch.tensor(32768.0, dtype=_F32, device=dev)

    def gauss(h, idx):
        """audio.rs:252-268: taps [0xFF-i], [0x1FF-i], [0x100+i], [i]."""
        g0 = table[0xFF - idx].to(_F32)
        g1 = table[0x1FF - idx].to(_F32)
        g2 = table[0x100 + idx].to(_F32)
        g3 = table[idx].to(_F32)
        return (g0 * h[:, 0] + g1 * h[:, 1] + g2 * h[:, 2]
                + g3 * h[:, 3]) / div

    hl, hr = state.history_l.clone(), state.history_r.clone()
    pc = state.pitch_counter.clone()
    al, ar = state.accum_l.clone(), state.accum_r.clone()
    ac = state.accum_count.clone()
    out_l = torch.empty_like(left)
    out_r = torch.empty_like(right)
    for i in range(left.shape[1]):
        l, r = left[:, i], right[:, i]
        al = al + l
        ar = ar + r
        ac = ac + 1
        push = ac >= ratio
        cnt = ac.to(_F32)
        avg_l = torch.clamp(al / cnt, -1.5, 1.5)
        avg_r = torch.clamp(ar / cnt, -1.5, 1.5)
        hl = torch.where(push[:, None],
                         torch.cat([hl[:, 1:], avg_l[:, None]], 1), hl)
        hr = torch.where(push[:, None],
                         torch.cat([hr[:, 1:], avg_r[:, None]], 1), hr)
        al = torch.where(push, torch.zeros_like(al), al)
        ar = torch.where(push, torch.zeros_like(ar), ar)
        ac = torch.where(push, torch.zeros_like(ac), ac)

        pc = pc + pitch
        idx = ((pc >> 4) & 0xFF).long()
        o_l = torch.clamp(gauss(hl, idx), -1.5, 1.5)
        o_r = torch.clamp(gauss(hr, idx), -1.5, 1.5)
        pc = torch.where(pc >= 0x1000, pc & 0xFFF, pc)
        out_l[:, i] = o_l if enabled else l
        out_r[:, i] = o_r if enabled else r
    new = ResamplerState(history_l=hl, history_r=hr, pitch_counter=pc,
                         accum_l=al, accum_r=ar, accum_count=ac)
    return _streams.unbatched(new, out_l, out_r, single)


def spu_resample(state: ResamplerState, left, right, pitch: int,
                 enabled: bool):
    """Launch the `spu_resample` kernel of csrc/audio.cu: the batched
    state tensors ((S, 4) histories, (S,) counters and sums) are updated
    IN PLACE; left/right (S, N) f32 on the same card; 0 < pitch <
    PITCH_NATIVE.  Returns the outputs (out_l, out_r), (S, N) f32."""
    from ..ops import _cuda
    dev = left.device
    streams, n = left.shape
    if _passes(pitch):
        raise ValueError(f"pitch {pitch:#x}: the kernel takes 0 < pitch < "
                         f"{PITCH_NATIVE:#x}")
    args = [_cuda._check("history_l", state.history_l, _F32, (streams, 4),
                         dev),
            _cuda._check("history_r", state.history_r, _F32, (streams, 4),
                         dev),
            _cuda._check("pitch_counter", state.pitch_counter, _I32,
                         (streams,), dev),
            _cuda._check("accum_l", state.accum_l, _F32, (streams,), dev),
            _cuda._check("accum_r", state.accum_r, _F32, (streams,), dev),
            _cuda._check("accum_count", state.accum_count, _I32, (streams,),
                         dev),
            _cuda._check("left", left, _F32, (streams, n), dev),
            _cuda._check("right", right, _F32, (streams, n), dev)]
    out = _streams.launch("spu_resample", args, left,
                          (int(pitch), PITCH_NATIVE // int(pitch),
                           int(bool(enabled))))
    spu_resample.launches += 1
    return out


spu_resample.launches = 0


def process(state: ResamplerState, left, right, pitch: int,
            enabled=True, inplace=False) -> Tuple[ResamplerState,
                                                  torch.Tensor,
                                                  torch.Tensor]:
    """audio.rs:280-345.  pitch is static (0x1000/0x0800/0x0400/0x0200);
    one outside (0, 0x1000) returns the state and the input as they are.
    left/right: (N,) or (S, N) f32 on the state's device (numpy arrays are
    moved there).  Returns (new_state, left_out, right_out).  On the card
    this is the `spu_resample` kernel, which updates a copy of `state`,
    or with `inplace` `state`'s own tensors (as reverb.process); on the
    CPU the plain twin `process_ref`, which never changes `state`."""
    dev = state.history_l.device
    if dev.type == "cpu" or _passes(pitch):
        return process_ref(state, left, right, pitch, enabled)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    st, left, right, single = _streams.batched(state, left, right)
    if not inplace:
        st = ResamplerState(*(t.clone() for t in st))
    out_l, out_r = spu_resample(st, left, right, pitch, enabled)
    return _streams.unbatched(st, out_l, out_r, single)

