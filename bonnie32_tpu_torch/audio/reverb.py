"""PS1 SPU hardware reverb (the JAX package's `audio/reverb.py`).

The reference's `src/tracker/psx_reverb.rs`: the nocash-spec SPU reverb —
IIR same-side/different-side wall reflections, 4 comb filters, 2 cascaded
all-pass filters over a circular buffer, processed at 22050 Hz half-rate
with Q15 saturating arithmetic.

The recurrence is sequential per stream; streams are independent and are
batched on a leading axis (the JAX package's `vmap`): every function takes
(N,) inputs with a state of unbatched tensors, or (S, N) inputs with a
state whose tensors lead with S.  `process` runs the hand-written kernel
`spu_reverb` of csrc/audio.cu for CUDA tensors and the plain twin
`process_ref` (a loop over samples in tensor ops, one op per rounding)
for CPU tensors.  Integer arithmetic is int32 as in the JAX package,
whose multiply wraps: so does this one's (`_mul_vol`).  The kernel runs
a stream's ticks over windows of its buffers staged in shared memory;
`window_layout` says where each tick's words lie there.
"""

import weakref
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..ops import fixed
from ..types import resolve_device
from . import _streams
from .spu_tables import REVERB_ORDER, REVERB_PRESETS

_I32 = torch.int32
_F32 = torch.float32

BUFFER_SIZE = 0x20000  # psx_reverb.rs:280
N_PARAMS = 32

# preset parameter vector layout (32 registers; psx_reverb.rs:70-105)
_IDX = dict(d_apf1=0, d_apf2=1, v_iir=2, v_comb1=3, v_comb2=4, v_comb3=5,
            v_comb4=6, v_wall=7, v_apf1=8, v_apf2=9, m_l_same=10, m_r_same=11,
            m_l_comb1=12, m_r_comb1=13, m_l_comb2=14, m_r_comb2=15,
            d_l_same=16, d_r_same=17, m_l_diff=18, m_r_diff=19,
            m_l_comb3=20, m_r_comb3=21, m_l_comb4=22, m_r_comb4=23,
            d_l_diff=24, d_r_diff=25, m_l_apf1=26, m_r_apf1=27,
            m_l_apf2=28, m_r_apf2=29, v_l_in=30, v_r_in=31)


def preset_params(reverb_type: int) -> np.ndarray:
    """Preset registers as int32 with i16 sign interpretation for volumes."""
    raw = np.asarray(REVERB_PRESETS[REVERB_ORDER[reverb_type]], np.int64)
    out = raw.copy()
    for name in ("v_iir", "v_comb1", "v_comb2", "v_comb3", "v_comb4",
                 "v_wall", "v_apf1", "v_apf2", "v_l_in", "v_r_in"):
        i = _IDX[name]
        v = raw[i]
        out[i] = v - 0x10000 if v >= 0x8000 else v
    return out.astype(np.int32)


class ReverbState(NamedTuple):
    buffer_l: torch.Tensor  # ([S,] BUFFER_SIZE) i32 (i16 values)
    buffer_r: torch.Tensor
    pos: torch.Tensor       # ([S]) i32
    accum: torch.Tensor     # ([S]) f32 fractional 22.05 kHz accumulator


def init_state(device=None, streams=None) -> ReverbState:
    """The silent state on `device` (default: the card): unbatched, or
    with a leading axis of `streams` independent streams."""
    dev = resolve_device(device)
    lead = () if streams is None else (int(streams),)
    return ReverbState(
        buffer_l=torch.zeros(lead + (BUFFER_SIZE,), dtype=_I32, device=dev),
        buffer_r=torch.zeros(lead + (BUFFER_SIZE,), dtype=_I32, device=dev),
        pos=torch.zeros(lead, dtype=_I32, device=dev),
        accum=torch.zeros(lead, dtype=_F32, device=dev))


def _batched(state: ReverbState, left, right, params):
    """`_streams.batched`, and params as (S, 32) int32 on the state's
    device."""
    state, left, right, single = _streams.batched(state, left, right)
    streams = left.shape[0]
    if isinstance(params, torch.Tensor):
        p = params.to(device=left.device, dtype=_I32)
    else:
        p = torch.as_tensor(np.asarray(params, np.int32), device=left.device)
    if p.shape == (N_PARAMS,):
        p = p.expand(streams, N_PARAMS)
    if tuple(p.shape) != (streams, N_PARAMS):
        raise ValueError(f"params {tuple(p.shape)}: expected (32,) or "
                         f"({streams}, 32)")
    return state, left, right, p.contiguous(), single


def _scalars(wet_level, output_volume, rate_ratio):
    """The f32 constants of the mix, as the JAX package forms them: wet
    and volume rounded to f32, dry = 1 - wet in f32, and the tick's
    increment 1 / rate_ratio taken in f64, then rounded."""
    wet = np.float32(wet_level)
    return (wet, np.float32(np.float32(1.0) - wet), np.float32(output_volume),
            np.float32(1.0 / float(rate_ratio)))


def _mul_vol(sample, volume):
    """(sample * volume) >> 15, clamped to i16 (psx_reverb.rs:383), with
    the product wrapped to 32 bits as XLA's int32 multiply does: taken in
    int64 and cut back to int32."""
    return torch.clamp((sample.long() * volume).to(_I32) >> 15,
                       -32768, 32767)


def _clamp16(x):
    return torch.clamp(x, -32768, 32767)


def process_ref(state: ReverbState, left, right, reverb_type_params,
                wet_level, output_volume=1.0, rate_ratio=2.0,
                enabled=True) -> Tuple[ReverbState, torch.Tensor,
                                       torch.Tensor]:
    """The plain twin of `spu_reverb` (reverb.py:75-198 of the JAX
    package): the same recurrence as a Python loop over samples, every
    stream of the batch at once; a stream whose 22.05 kHz tick does not
    fall on a sample leaves its buffers and position as they were there.
    Returns (new_state, left_out, right_out); `state` is not changed."""
    state, left, right, p, single = _batched(state, left, right,
                                             reverb_type_params)
    dev = left.device
    streams, n = left.shape

    def c(x):   # an f32 constant on the device (a division stays one)
        return torch.tensor(float(x), dtype=_F32, device=dev)

    wet_f, _, vol_f, inc_f = _scalars(wet_level, output_volume, rate_ratio)
    wet = c(wet_f)
    dry = 1.0 - wet
    vol, inc, q15 = c(vol_f), c(inc_f), c(32767.0)
    reg = {k: p[:, i].long() for k, i in _IDX.items()}
    rows = torch.arange(streams, device=dev)
    buf_l = state.buffer_l.clone()
    buf_r = state.buffer_r.clone()
    pos = state.pos.long()
    accum = state.accum.clone()
    last_l = torch.zeros(streams, dtype=_I32, device=dev)
    last_r = torch.zeros_like(last_l)
    out_l = torch.empty_like(left)
    out_r = torch.empty_like(right)

    def at(off):
        return (pos + off) & (BUFFER_SIZE - 1)

    def rd(buf, off):
        return buf[rows, at(off)]

    def wr(buf, off, val, ticked):
        i = at(off)
        buf[rows, i] = torch.where(ticked, _clamp16(val), buf[rows, i])

    def masked(name, sub):
        return (reg[name] - sub) & 0xFFFF

    def q15_of(x):
        return fixed.f32_to_i32(torch.clamp(torch.trunc(x * q15), -32768.0,
                                            32767.0))

    for i in range(n):
        l, r = left[:, i], right[:, i]
        accum = accum + inc
        ticked = accum >= 1.0

        # sample22k (psx_reverb.rs:383-463), every stream; the writes
        # take effect where the stream ticks
        l_in = _mul_vol(q15_of(l), reg["v_l_in"])
        r_in = _mul_vol(q15_of(r), reg["v_r_in"])

        d_l_same = rd(buf_l, reg["d_l_same"])
        prev = rd(buf_l, masked("m_l_same", 2))
        same_in = l_in + _mul_vol(d_l_same, reg["v_wall"])
        wr(buf_l, reg["m_l_same"],
           _mul_vol(same_in - prev, reg["v_iir"]) + prev, ticked)

        d_r_same = rd(buf_r, reg["d_r_same"])
        prev = rd(buf_r, masked("m_r_same", 2))
        same_in = r_in + _mul_vol(d_r_same, reg["v_wall"])
        wr(buf_r, reg["m_r_same"],
           _mul_vol(same_in - prev, reg["v_iir"]) + prev, ticked)

        d_r_diff = rd(buf_r, reg["d_r_diff"])
        prev = rd(buf_l, masked("m_l_diff", 2))
        diff_in = l_in + _mul_vol(d_r_diff, reg["v_wall"])
        wr(buf_l, reg["m_l_diff"],
           _mul_vol(diff_in - prev, reg["v_iir"]) + prev, ticked)

        d_l_diff = rd(buf_l, reg["d_l_diff"])
        prev = rd(buf_r, masked("m_r_diff", 2))
        diff_in = r_in + _mul_vol(d_l_diff, reg["v_wall"])
        wr(buf_r, reg["m_r_diff"],
           _mul_vol(diff_in - prev, reg["v_iir"]) + prev, ticked)

        outs = []
        for side, buf in (("l", buf_l), ("r", buf_r)):
            o = (_mul_vol(rd(buf, reg[f"m_{side}_comb1"]), reg["v_comb1"])
                 + _mul_vol(rd(buf, reg[f"m_{side}_comb2"]), reg["v_comb2"])
                 + _mul_vol(rd(buf, reg[f"m_{side}_comb3"]), reg["v_comb3"])
                 + _mul_vol(rd(buf, reg[f"m_{side}_comb4"]),
                            reg["v_comb4"]))
            outs.append(o)
        # the all-pass filters: left then right, stage by stage
        for stage in ("1", "2"):
            for k, (side, buf) in enumerate((("l", buf_l), ("r", buf_r))):
                m = f"m_{side}_apf{stage}"
                v = reg[f"v_apf{stage}"]
                ap = rd(buf, (reg[m] - reg[f"d_apf{stage}"]) & 0xFFFF)
                o = outs[k] - _mul_vol(ap, v)
                wr(buf, reg[m], o, ticked)
                outs[k] = _mul_vol(o, v) + ap

        pos = torch.where(ticked, (pos + 1) & (BUFFER_SIZE - 1), pos)
        last_l = torch.where(ticked, _clamp16(outs[0]), last_l)
        last_r = torch.where(ticked, _clamp16(outs[1]), last_r)
        accum = torch.where(ticked, accum - 1.0, accum)

        mix = ticked & enabled
        lw = last_l.to(_F32) / q15
        rw = last_r.to(_F32) / q15
        out_l[:, i] = torch.where(mix, (l * dry + lw * wet) * vol, l)
        out_r[:, i] = torch.where(mix, (r * dry + rw * wet) * vol, r)

    new = ReverbState(buffer_l=buf_l, buffer_r=buf_r, pos=pos.to(_I32),
                      accum=accum)
    return _streams.unbatched(new, out_l, out_r, single)


# The kernel's window: at most WINDOW 22.05 kHz ticks and WINDOW_SAMPLES
# samples a pass over shared memory (one 60 Hz frame is 735 samples, 367
# or 368 ticks, so a frame is one window).
WINDOW = 368
WINDOW_SAMPLES = 736
SHARED_BYTES = 227 * 1024      # a block's shared memory on the H100
LAYOUT_WORDS = 5 + 2 * 14 + 2 * 14 * 4

# Every access of one tick to one side's buffer, in the slot order of
# csrc/audio.cu's `Slot`: (register, subtracted register or a constant,
# writes).  A read of `(m - d) & 0xFFFF` names m and d; a plain read or
# write names its register alone.
_SIDE_ACCESS = (("d_{s}_same", None, False), ("m_{s}_same", 2, False),
                ("m_{s}_same", None, True), ("m_{s}_diff", 2, False),
                ("m_{s}_diff", None, True), ("d_{s}_diff", None, False),
                ("m_{s}_comb1", None, False), ("m_{s}_comb2", None, False),
                ("m_{s}_comb3", None, False), ("m_{s}_comb4", None, False),
                ("m_{s}_apf1", "d_apf1", False), ("m_{s}_apf1", None, True),
                ("m_{s}_apf2", "d_apf2", False), ("m_{s}_apf2", None, True))
# The writes of its own side that a tick makes before each read, in the
# JAX order (reverb.py:93-164): slot -> earlier write slots, per side
# (the right side reads d_r_diff before it writes m_r_diff).
_SAME, _DIFF, _APF1 = 2, 4, 11
_EARLIER_WRITES = tuple(
    {3: (_SAME,), 5: (_SAME,) + ((_DIFF,) if side == 0 else ()),
     **{c: (_SAME, _DIFF) for c in (6, 7, 8, 9)}, 10: (_SAME, _DIFF),
     12: (_SAME, _DIFF, _APF1)} for side in range(2))


class WindowLayout(NamedTuple):
    """Where a window of `window` ticks finds each word in shared memory,
    per side (0: buffer_l, 1: buffer_r).  The access of slot k at tick t
    addresses buffer word (pos + offsets[side, k] + t) % BUFFER_SIZE and
    shared word slots[side, k] + t; `runs[side]` are the (start offset
    from pos, length, shared base, written) of the merged runs staged
    there, `words[side]` their total length.  `paired`: no read finds a
    word that its own tick wrote before it or that the tick before wrote,
    so two ticks can load all their words before either stores."""
    window: int
    offsets: np.ndarray     # (2, 14) int64, in [0, BUFFER_SIZE)
    slots: np.ndarray       # (2, 14) int64
    runs: tuple
    words: np.ndarray       # (2,) int64
    paired: bool


def side_offsets(params) -> np.ndarray:
    """The 14 accesses of a tick to each side's buffer as offsets from
    pos, modulo BUFFER_SIZE, in `_SIDE_ACCESS` order: (2, 14) int64."""
    p = np.asarray(params, np.int64)
    out = np.zeros((2, len(_SIDE_ACCESS)), np.int64)
    for side, name in enumerate("lr"):
        for k, (reg, sub, _) in enumerate(_SIDE_ACCESS):
            v = int(p[_IDX[reg.format(s=name)]])
            if sub is not None:
                d = sub if isinstance(sub, int) else int(p[_IDX[sub]])
                v = (v - d) & 0xFFFF
            out[side, k] = v % BUFFER_SIZE
    return out


def window_layout(params, window: int = WINDOW) -> WindowLayout:
    """The shared-memory layout of a window of `window` ticks for one row
    of the 32 registers.  Each offset o covers the words [o, o + window)
    from the window's first pos; offsets whose ranges overlap merge into
    one run, so two accesses reach the same buffer word within the
    window exactly when they reach the same shared word.  Runs wrap
    modulo BUFFER_SIZE."""
    if not 0 < window <= BUFFER_SIZE // (2 * len(_SIDE_ACCESS)):
        raise ValueError(f"window {window}: expected 1 .. "
                         f"{BUFFER_SIZE // (2 * len(_SIDE_ACCESS))}")
    offsets = side_offsets(params)
    slots = np.zeros_like(offsets)
    runs, words = [], np.zeros(2, np.int64)
    for side in range(2):
        uniq = sorted(set(int(o) for o in offsets[side]))
        # start after a gap of at least `window` (one exists: at most 14
        # offsets share BUFFER_SIZE words), so no run crosses the cut
        gaps = [(uniq[(i + 1) % len(uniq)] - uniq[i]) % BUFFER_SIZE
                or BUFFER_SIZE for i in range(len(uniq))]
        cut = next(i for i, g in enumerate(gaps) if g >= window)
        line = [uniq[(cut + 1 + i) % len(uniq)] for i in range(len(uniq))]
        line = [v + BUFFER_SIZE * (v < line[0]) for v in line]
        merged = []                     # [first offset, end] unwrapped
        for v in line:
            if merged and v < merged[-1][1]:
                merged[-1][1] = v + window
            else:
                merged.append([v, v + window])
        side_runs, base = [], 0
        for lo, hi in merged:
            writes = False
            for k, (_, _, w) in enumerate(_SIDE_ACCESS):
                u = int(offsets[side, k])
                u += BUFFER_SIZE * (u < line[0])
                if lo <= u < hi:
                    slots[side, k] = base + u - lo
                    writes |= w
            side_runs.append((lo % BUFFER_SIZE, hi - lo, base, writes))
            base += hi - lo
        runs.append(tuple(side_runs))
        words[side] = base
    return WindowLayout(window, offsets, slots, tuple(runs), words,
                        _paired(slots))


def _paired(slots) -> bool:
    """Whether no read of a tick reaches a word written earlier in the
    same tick (same slot) or in the tick before (its slot one below the
    write's)."""
    for side in range(2):
        for k, (_, _, writes) in enumerate(_SIDE_ACCESS):
            if writes:
                continue
            for w in (j for j, a in enumerate(_SIDE_ACCESS) if a[2]):
                gap = slots[side, w] - slots[side, k]
                if gap == 1 or (gap == 0
                                and w in _EARLIER_WRITES[side].get(k, ())):
                    return False
    return True


def layout_table(layout: WindowLayout) -> np.ndarray:
    """The kernel's int32 table of a layout (LAYOUT_WORDS,): the shared
    words of each side, their numbers of runs, `paired`, the 14 slots of
    each side, then each side's runs as (start, length, base, written),
    14 places a side."""
    t = np.zeros(LAYOUT_WORDS, np.int32)
    t[0:2] = layout.words
    t[2:4] = [len(r) for r in layout.runs]
    t[4] = layout.paired
    t[5:33] = layout.slots.reshape(-1)
    for side, side_runs in enumerate(layout.runs):
        at = 33 + side * 14 * 4
        for r, run in enumerate(side_runs):
            t[at + 4 * r:at + 4 * r + 4] = run
    return t


def shared_bytes(words_l: int, words_r: int) -> int:
    """The kernel's dynamic shared memory for one stream's layout: both
    sides' runs, three words a sample of the window (its two inputs and
    its tick) and three a tick (its sample and its two outputs)."""
    return 4 * (int(words_l) + int(words_r) + 3 * WINDOW_SAMPLES
                + 3 * WINDOW)


class WindowTables(NamedTuple):
    """The kernel's layouts of one call's rows."""
    table: torch.Tensor     # (S, LAYOUT_WORDS) int32, on the rows' device
    shared_bytes: int       # the largest row's `shared_bytes`


_tables = {}    # id(params tensor) -> (weakref, version, shape, tables)


def _layout_tables(params, p) -> WindowTables:
    """The window layouts, on `p`'s device, of the register rows `p`
    (S, 32) that the caller gave as `params`: a tensor (`stream.SpuChain`
    gives the same one every call) is read to the host once and its
    tables kept while it lives unchanged; other rows are laid out from
    their values.  One layout per distinct row."""
    key = id(params)
    if isinstance(params, torch.Tensor):
        hit = _tables.get(key)
        if (hit is not None and hit[0]() is params
                and hit[1] == params._version and hit[2] == p.shape
                and hit[3].table.device == p.device):
            return hit[3]
    rows = (p.cpu().numpy() if isinstance(params, torch.Tensor)
            else np.broadcast_to(np.asarray(params, np.int32), p.shape))
    distinct, which = np.unique(rows, axis=0, return_inverse=True)
    tables = np.stack([layout_table(window_layout(r)) for r in distinct])
    out = WindowTables(
        torch.from_numpy(tables[which.reshape(-1)]).to(p.device),
        max(shared_bytes(*t[0:2]) for t in tables))
    if isinstance(params, torch.Tensor):
        for k in [k for k, v in _tables.items() if v[0]() is None]:
            del _tables[k]
        _tables[key] = (weakref.ref(params), params._version, p.shape, out)
    return out


def spu_reverb(state: ReverbState, left, right, params, wet, dry, vol, inc,
               enabled: bool, layouts=None):
    """Launch the `spu_reverb` kernel of csrc/audio.cu: batched state
    tensors ((S, BUFFER_SIZE) i32 buffers, (S,) i32 pos, (S,) f32 accum)
    are updated IN PLACE; left/right (S, N) f32 and params (S, 32) i32 on
    the same card; wet, dry, vol and inc are the f32 constants of
    `_scalars`.  `layouts`: the rows' `WindowTables` on the card
    (default: laid out here, kept while `params` lives unchanged).
    Returns the outputs (out_l, out_r), (S, N) f32."""
    from ..ops import _cuda
    dev = left.device
    streams, n = left.shape
    if layouts is None:
        layouts = _layout_tables(params, params)
    args = [_cuda._check("buffer_l", state.buffer_l, _I32,
                         (streams, BUFFER_SIZE), dev),
            _cuda._check("buffer_r", state.buffer_r, _I32,
                         (streams, BUFFER_SIZE), dev),
            _cuda._check("pos", state.pos, _I32, (streams,), dev),
            _cuda._check("accum", state.accum, _F32, (streams,), dev),
            _cuda._check("params", params, _I32, (streams, N_PARAMS), dev),
            _cuda._check("layouts", layouts.table, _I32,
                         (streams, LAYOUT_WORDS), dev),
            _cuda._check("left", left, _F32, (streams, n), dev),
            _cuda._check("right", right, _F32, (streams, n), dev)]
    out = _streams.launch("spu_reverb", args, left,
                          (float(wet), float(dry), float(vol), float(inc),
                           int(bool(enabled)), WINDOW, WINDOW_SAMPLES,
                           layouts.shared_bytes))
    spu_reverb.launches += 1
    return out


spu_reverb.launches = 0


def process(state: ReverbState, left, right, reverb_type_params,
            wet_level, output_volume=1.0, rate_ratio=2.0,
            enabled=True, inplace=False
            ) -> Tuple[ReverbState, torch.Tensor, torch.Tensor]:
    """Process f32 sample arrays through the reverb (psx_reverb.rs:477-520).

    left/right: (N,) or (S, N) f32 in [-1, 1], on the state's device (numpy
    arrays are moved there).  reverb_type_params: (32,) i32 preset
    registers (see preset_params), or (S, 32), one preset a stream.
    rate_ratio: output rate / 22050.  `enabled` False passes the input
    through while the state runs on.  Returns (new_state, left_out,
    right_out).  On the card this is the `spu_reverb` kernel, which
    updates a copy of `state`, or with `inplace` (for a caller that gives
    the old state up, as `stream.SpuChain` does) `state`'s own tensors,
    saving a 1 MiB copy a call; on the CPU the plain twin `process_ref`,
    which never changes `state`.
    """
    dev = state.buffer_l.device
    if dev.type == "cpu":
        return process_ref(state, left, right, reverb_type_params,
                           wet_level, output_volume, rate_ratio, enabled)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    st, left, right, p, single = _batched(state, left, right,
                                          reverb_type_params)
    if not inplace:
        st = ReverbState(*(t.clone() for t in st))
    out_l, out_r = spu_reverb(st, left, right, p,
                              *_scalars(wet_level, output_volume,
                                        rate_ratio), bool(enabled),
                              _layout_tables(reverb_type_params, p))
    return _streams.unbatched(st, out_l, out_r, single)
