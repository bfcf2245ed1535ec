"""PS1 SPU Gaussian resampler (the JAX package's `audio/resampler.py`).

The 4-tap Gaussian interpolation resampler of the reference's
`src/tracker/audio.rs:176-345`: downsample-by-averaging to the SPU pitch
rate, then re-interpolate at 44.1 kHz with the hardware's 512-entry
Gaussian ROM indexed by bits 4-11 of the pitch counter — the
characteristic warm/muffled PS1 sound.

A recurrence per stream in the JAX package, but nothing chains through
the data except each averaging block's sum, so the kernel and its twin
compute every sample at once (`process_ref` says how); streams are
batched on a leading axis as in audio/reverb.py.  `process` runs the
hand-written kernel `spu_resample` of csrc/audio.cu for CUDA tensors and
the plain twin `process_ref` for CPU tensors.
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
SEGMENT = 1024     # samples a block of the kernel (csrc/audio.cu kSegment)


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
    package), every sample of every stream at once, as the kernel splits
    it.  Returns (new_state, left_out, right_out); `state` is not changed.

    Nothing chains through the data but each block's sum.  The carried
    count c0 fixes where blocks end: the first push falls on sample
    p0 = max(0, ratio - c0 - 1) (on the first sample, with count c0 + 1,
    where the caller changed the pitch and c0 >= ratio), the k-th on
    p0 + k * ratio.  Each block's average is its samples summed in order
    (the first from the carried sums), over its count, clipped; sample i
    reads the four newest averages pushed up to it (the carried history
    fills the first), and its Gaussian index is bits 4-11 of
    pc0 + (i + 1) * pitch, which the counter's `& 0xFFF` never changes.
    """
    if _passes(pitch):
        dev = state.history_l.device
        return (state, torch.as_tensor(left, dtype=_F32, device=dev),
                torch.as_tensor(right, dtype=_F32, device=dev))
    state, left, right, single = _streams.batched(state, left, right)
    if left.shape[1] == 0:
        new = ResamplerState(*(t.clone() for t in state))
        return _streams.unbatched(new, left.clone(), right.clone(), single)
    dev = left.device
    streams, n = left.shape
    ratio = PITCH_NATIVE // pitch
    table = torch.tensor(GAUSSIAN_TABLE, dtype=_I32, device=dev)
    div = torch.tensor(32768.0, dtype=_F32, device=dev)

    c0 = state.accum_count.long()[:, None]                  # (S, 1)
    first = torch.clamp(ratio - c0 - 1, min=0)
    # blocks 0 .. K-1 end on p0 + k * ratio; the one after the last push
    # is the call's tail, cut at n
    blocks = torch.arange((n - 1) // ratio + 2, device=dev)
    ends = first + blocks * ratio                           # (S, K)
    pushes = torch.where(first < n, (n - 1 - first) // ratio + 1, 0)
    count = torch.where(blocks == 0, c0 + first + 1, ratio)
    sums = []
    for x, carried in ((left, state.accum_l), (right, state.accum_r)):
        acc = torch.where(blocks == 0, carried[:, None], 0.0)
        for j in range(ratio):
            at = ends - (ratio - 1) + j
            live = (at >= 0) & (at < n)
            acc = torch.where(live, acc + torch.gather(
                x, 1, at.clamp(0, n - 1)), acc)
        sums.append(acc)
    cnt = count.to(_F32)

    def history(h, total):
        """The carried history, then every block's average."""
        return torch.cat([h, torch.clamp(total / cnt, -1.5, 1.5)], 1)

    seq_l = history(state.history_l, sums[0])
    seq_r = history(state.history_r, sums[1])
    i = torch.arange(n, device=dev)
    newest = torch.where(i >= first, (i - first) // ratio + 1, 0)  # (S, N)
    pc = state.pitch_counter.long()[:, None]
    idx = ((pc + (i + 1) * pitch) >> 4) & 0xFF
    g0 = table[0xFF - idx].to(_F32)
    g1 = table[0x1FF - idx].to(_F32)
    g2 = table[0x100 + idx].to(_F32)
    g3 = table[idx].to(_F32)

    def gauss(seq):
        """audio.rs:252-268: taps [0xFF-i], [0x1FF-i], [0x100+i], [i]
        over the four newest averages, oldest first."""
        s0, s1, s2, s3 = (torch.gather(seq, 1, newest + k) for k in range(4))
        return torch.clamp((g0 * s0 + g1 * s1 + g2 * s2 + g3 * s3) / div,
                           -1.5, 1.5)

    out_l = gauss(seq_l) if enabled else left.clone()
    out_r = gauss(seq_r) if enabled else right.clone()
    last = pushes + torch.arange(4, device=dev)             # (S, 4)
    tail = pushes                                           # block index
    final = pc[:, 0] + n * pitch
    new = ResamplerState(
        history_l=torch.gather(seq_l, 1, last),
        history_r=torch.gather(seq_r, 1, last),
        pitch_counter=torch.where(final >= 0x1000, final & 0xFFF,
                                  final).to(_I32),
        accum_l=torch.gather(sums[0], 1, tail)[:, 0],
        accum_r=torch.gather(sums[1], 1, tail)[:, 0],
        accum_count=torch.where(
            pushes[:, 0] == 0, c0[:, 0] + n,
            n - 1 - (first[:, 0] + (pushes[:, 0] - 1) * ratio)).to(_I32))
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
    # a call over several segments finds its new state by a ticket
    # counter a stream, which the kernel leaves at zero
    tickets = (torch.zeros(streams, dtype=_I32, device=dev)
               if n > SEGMENT else None)
    out = _streams.launch("spu_resample", args, left,
                          (int(pitch), PITCH_NATIVE // int(pitch),
                           int(bool(enabled)),
                           None if tickets is None else tickets.data_ptr()))
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

