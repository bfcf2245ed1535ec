"""SoundFont 2 (.sf2) parser.
(The port's own copy of the JAX package's `audio/sf2.py`, host code.)

The reference renders tracker songs through rustysynth's SF2 synthesizer
(the reference's `src/tracker/audio.rs:14,650`: `SoundFont::new(reader)` +
`Synthesizer`).  This module parses the same on-disk format: a RIFF `sfbk`
tree with the INFO list, the 16-bit PCM `smpl` chunk, and the nine pdta
hydra sub-chunks (phdr/pbag/pmod/pgen/inst/ibag/imod/igen/shdr), resolved
into per-key/velocity *regions* the synthesizer (sf2_synth.py) plays.

Generator semantics follow the SoundFont 2.04 spec with rustysynth's
resolution rules: instrument-zone generators SET values, preset-zone
generators ADD to them (value generators), global zones provide defaults
within their level, and keyRange/velRange filter zone applicability.
"""

import io
import struct
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np

# Generator opcodes (SF2 spec section 8.1.2)
G_START_OFFS = 0
G_END_OFFS = 1
G_STARTLOOP_OFFS = 2
G_ENDLOOP_OFFS = 3
G_START_COARSE = 4
G_END_COARSE = 12
G_STARTLOOP_COARSE = 45
G_ENDLOOP_COARSE = 50
G_INITIAL_FILTER_FC = 8
G_INITIAL_FILTER_Q = 9
G_MOD_LFO_TO_PITCH = 5
G_VIB_LFO_TO_PITCH = 6
G_MOD_ENV_TO_PITCH = 7
G_MOD_LFO_TO_FILTER_FC = 10
G_MOD_ENV_TO_FILTER_FC = 11
G_MOD_LFO_TO_VOLUME = 13
G_PAN = 17
G_DELAY_MOD_LFO = 21
G_FREQ_MOD_LFO = 22
G_DELAY_VIB_LFO = 23
G_FREQ_VIB_LFO = 24
G_DELAY_MOD_ENV = 25
G_ATTACK_MOD_ENV = 26
G_HOLD_MOD_ENV = 27
G_DECAY_MOD_ENV = 28
G_SUSTAIN_MOD_ENV = 29
G_RELEASE_MOD_ENV = 30
G_KEYNUM_TO_MOD_HOLD = 31
G_KEYNUM_TO_MOD_DECAY = 32
G_DELAY_VOL_ENV = 33
G_ATTACK_VOL_ENV = 34
G_HOLD_VOL_ENV = 35
G_DECAY_VOL_ENV = 36
G_SUSTAIN_VOL_ENV = 37
G_RELEASE_VOL_ENV = 38
G_KEYNUM_TO_HOLD = 39
G_KEYNUM_TO_DECAY = 40
G_INSTRUMENT = 41
G_KEY_RANGE = 43
G_VEL_RANGE = 44
G_INITIAL_ATTENUATION = 48
G_COARSE_TUNE = 51
G_FINE_TUNE = 52
G_SAMPLE_ID = 53
G_SAMPLE_MODES = 54
G_SCALE_TUNING = 56
G_EXCLUSIVE_CLASS = 57
G_OVERRIDE_ROOT_KEY = 58

# Default generator values (SF2 spec 8.1.3); only the ones we resolve.
_DEFAULTS = {
    G_INITIAL_FILTER_FC: 13500,
    G_INITIAL_FILTER_Q: 0,
    G_MOD_LFO_TO_PITCH: 0,
    G_VIB_LFO_TO_PITCH: 0,
    G_MOD_ENV_TO_PITCH: 0,
    G_MOD_LFO_TO_FILTER_FC: 0,
    G_MOD_ENV_TO_FILTER_FC: 0,
    G_MOD_LFO_TO_VOLUME: 0,
    G_DELAY_MOD_LFO: -12000,
    G_FREQ_MOD_LFO: 0,
    G_DELAY_VIB_LFO: -12000,
    G_FREQ_VIB_LFO: 0,
    G_DELAY_MOD_ENV: -12000,
    G_ATTACK_MOD_ENV: -12000,
    G_HOLD_MOD_ENV: -12000,
    G_DECAY_MOD_ENV: -12000,
    G_SUSTAIN_MOD_ENV: 0,
    G_RELEASE_MOD_ENV: -12000,
    G_KEYNUM_TO_MOD_HOLD: 0,
    G_KEYNUM_TO_MOD_DECAY: 0,
    G_PAN: 0,
    G_DELAY_VOL_ENV: -12000,
    G_ATTACK_VOL_ENV: -12000,
    G_HOLD_VOL_ENV: -12000,
    G_DECAY_VOL_ENV: -12000,
    G_SUSTAIN_VOL_ENV: 0,
    G_RELEASE_VOL_ENV: -12000,
    G_KEYNUM_TO_HOLD: 0,
    G_KEYNUM_TO_DECAY: 0,
    G_INITIAL_ATTENUATION: 0,
    G_COARSE_TUNE: 0,
    G_FINE_TUNE: 0,
    G_SAMPLE_MODES: 0,
    G_SCALE_TUNING: 100,
    G_EXCLUSIVE_CLASS: 0,
    G_OVERRIDE_ROOT_KEY: -1,
    G_START_OFFS: 0, G_END_OFFS: 0,
    G_STARTLOOP_OFFS: 0, G_ENDLOOP_OFFS: 0,
    G_START_COARSE: 0, G_END_COARSE: 0,
    G_STARTLOOP_COARSE: 0, G_ENDLOOP_COARSE: 0,
}

# Value generators where preset zones ADD to the instrument-level value
# (ranges/sampleID/sampleModes/exclusiveClass and address offsets are
# instrument-only per spec 8.5).
_PRESET_ADDITIVE = {
    G_INITIAL_FILTER_FC, G_INITIAL_FILTER_Q, G_PAN,
    G_DELAY_VOL_ENV, G_ATTACK_VOL_ENV, G_HOLD_VOL_ENV, G_DECAY_VOL_ENV,
    G_SUSTAIN_VOL_ENV, G_RELEASE_VOL_ENV, G_KEYNUM_TO_HOLD,
    G_KEYNUM_TO_DECAY, G_INITIAL_ATTENUATION, G_COARSE_TUNE, G_FINE_TUNE,
    G_SCALE_TUNING,
    G_MOD_LFO_TO_PITCH, G_VIB_LFO_TO_PITCH, G_MOD_ENV_TO_PITCH,
    G_MOD_LFO_TO_FILTER_FC, G_MOD_ENV_TO_FILTER_FC, G_MOD_LFO_TO_VOLUME,
    G_DELAY_MOD_LFO, G_FREQ_MOD_LFO, G_DELAY_VIB_LFO, G_FREQ_VIB_LFO,
    G_DELAY_MOD_ENV, G_ATTACK_MOD_ENV, G_HOLD_MOD_ENV, G_DECAY_MOD_ENV,
    G_SUSTAIN_MOD_ENV, G_RELEASE_MOD_ENV, G_KEYNUM_TO_MOD_HOLD,
    G_KEYNUM_TO_MOD_DECAY,
}


class SampleHeader(NamedTuple):
    name: str
    start: int
    end: int
    start_loop: int
    end_loop: int
    sample_rate: int
    original_key: int
    correction: int          # pitch correction in cents
    sample_link: int
    sample_type: int


class Region(NamedTuple):
    """One playable key/vel region with fully-resolved generators."""

    key_lo: int
    key_hi: int
    vel_lo: int
    vel_hi: int
    sample: int              # index into SoundFont.sample_headers
    sample_modes: int        # 0 no loop, 1 continuous, 3 loop-until-release
    root_key: int
    coarse_tune: int
    fine_tune: int           # cents (incl. sample correction)
    scale_tuning: int
    pan: int                 # -500..500 (0.1% units)
    initial_attenuation: int  # centibels * 10 per spec (0.1 dB units)
    delay_vol_env: int       # timecents
    attack_vol_env: int
    hold_vol_env: int
    decay_vol_env: int
    sustain_vol_env: int     # centibels of attenuation
    release_vol_env: int
    initial_filter_fc: int   # absolute cents
    initial_filter_q: int    # centibels
    exclusive_class: int
    start: int               # resolved absolute sample frame indices
    end: int
    start_loop: int
    end_loop: int
    # modulator generators (rustysynth voice model; audio.rs:516-700).
    # Defaults are the SF2 spec 8.1.3 defaults = modulation disabled.
    keynum_to_vol_hold: int = 0      # timecents/keynum
    keynum_to_vol_decay: int = 0
    mod_lfo_to_pitch: int = 0        # cents
    vib_lfo_to_pitch: int = 0        # cents
    mod_env_to_pitch: int = 0        # cents
    mod_lfo_to_filter_fc: int = 0    # cents
    mod_env_to_filter_fc: int = 0    # cents
    mod_lfo_to_volume: int = 0       # centibels
    delay_mod_lfo: int = -12000      # timecents
    freq_mod_lfo: int = 0            # abs cents (8.176 Hz at 0)
    delay_vib_lfo: int = -12000
    freq_vib_lfo: int = 0
    delay_mod_env: int = -12000
    attack_mod_env: int = -12000
    hold_mod_env: int = -12000
    decay_mod_env: int = -12000
    sustain_mod_env: int = 0         # -0.1% units
    release_mod_env: int = -12000
    keynum_to_mod_hold: int = 0
    keynum_to_mod_decay: int = 0


class Preset(NamedTuple):
    name: str
    bank: int
    patch: int
    regions: Tuple[Region, ...]


class SoundFont(NamedTuple):
    info: Dict[str, str]
    samples: np.ndarray              # (N,) int16 PCM
    sample_headers: Tuple[SampleHeader, ...]
    presets: Tuple[Preset, ...]

    def find_preset(self, bank: int, patch: int) -> Optional[Preset]:
        for p in self.presets:
            if p.bank == bank and p.patch == patch:
                return p
        # GM fallback: same patch any bank, then patch 0 (rustysynth picks
        # the first preset when the exact program is missing)
        for p in self.presets:
            if p.patch == patch:
                return p
        return self.presets[0] if self.presets else None


def _read_chunk_header(f) -> Tuple[bytes, int]:
    hdr = f.read(8)
    if len(hdr) < 8:
        raise ValueError("unexpected EOF in RIFF structure")
    cid, size = struct.unpack("<4sI", hdr)
    return cid, size


def _parse_info(data: bytes) -> Dict[str, str]:
    info = {}
    f = io.BytesIO(data)
    while f.tell() < len(data):
        cid, size = _read_chunk_header(f)
        raw = f.read(size + (size & 1))[:size]
        if cid == b"ifil":
            major, minor = struct.unpack("<HH", raw[:4])
            info["ifil"] = f"{major}.{minor}"
        else:
            info[cid.decode("ascii")] = raw.split(b"\0")[0].decode(
                "latin-1", "replace")
    return info


def _records(data: bytes, size: int):
    for off in range(0, len(data) - size + 1, size):
        yield data[off:off + size]


def _zone_gens(bag: List[Tuple[int, int]], gens: List[Tuple[int, int]],
               zone_idx: int) -> List[Tuple[int, int]]:
    g0 = bag[zone_idx][0]
    g1 = bag[zone_idx + 1][0] if zone_idx + 1 < len(bag) else len(gens)
    return gens[g0:g1]


def load(path_or_bytes) -> SoundFont:
    """Parse an .sf2 file (path, bytes, or file object)."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        f = io.BytesIO(path_or_bytes)
    elif hasattr(path_or_bytes, "read"):
        f = path_or_bytes
    else:
        f = open(path_or_bytes, "rb")

    cid, size = _read_chunk_header(f)
    if cid != b"RIFF":
        raise ValueError("not a RIFF file")
    if f.read(4) != b"sfbk":
        raise ValueError("not an sfbk (SoundFont) RIFF form")

    info: Dict[str, str] = {}
    samples = np.zeros(0, np.int16)
    pdta: Dict[bytes, bytes] = {}

    remaining = size - 4
    while remaining > 8:
        cid, csize = _read_chunk_header(f)
        remaining -= 8 + csize + (csize & 1)
        if cid != b"LIST":
            f.seek(csize + (csize & 1), 1)
            continue
        list_type = f.read(4)
        payload = f.read(csize - 4 + (csize & 1))[:csize - 4]
        if list_type == b"INFO":
            info = _parse_info(payload)
        elif list_type == b"sdta":
            pf = io.BytesIO(payload)
            while pf.tell() < len(payload):
                scid, ssize = _read_chunk_header(pf)
                raw = pf.read(ssize + (ssize & 1))[:ssize]
                if scid == b"smpl":
                    samples = np.frombuffer(raw, dtype="<i2").copy()
        elif list_type == b"pdta":
            pf = io.BytesIO(payload)
            while pf.tell() < len(payload):
                scid, ssize = _read_chunk_header(pf)
                pdta[scid] = pf.read(ssize + (ssize & 1))[:ssize]

    for req in (b"phdr", b"pbag", b"pgen", b"inst", b"ibag", b"igen",
                b"shdr"):
        if req not in pdta:
            raise ValueError(f"missing pdta sub-chunk {req.decode()}")

    # --- hydra records ---
    phdr = []
    for r in _records(pdta[b"phdr"], 38):
        name = r[:20].split(b"\0")[0].decode("latin-1", "replace")
        patch, bank, bag_ndx = struct.unpack("<HHH", r[20:26])
        phdr.append((name, patch, bank, bag_ndx))
    pbag = [struct.unpack("<HH", r) for r in _records(pdta[b"pbag"], 4)]
    pgen = [struct.unpack("<Hh", r) for r in _records(pdta[b"pgen"], 4)]
    inst = []
    for r in _records(pdta[b"inst"], 22):
        name = r[:20].split(b"\0")[0].decode("latin-1", "replace")
        (bag_ndx,) = struct.unpack("<H", r[20:22])
        inst.append((name, bag_ndx))
    ibag = [struct.unpack("<HH", r) for r in _records(pdta[b"ibag"], 4)]
    igen = [struct.unpack("<Hh", r) for r in _records(pdta[b"igen"], 4)]

    shdr: List[SampleHeader] = []
    for r in _records(pdta[b"shdr"], 46):
        name = r[:20].split(b"\0")[0].decode("latin-1", "replace")
        start, end, sl, el, rate = struct.unpack("<IIIII", r[20:40])
        okey, corr = r[40], struct.unpack("<b", r[41:42])[0]
        link, stype = struct.unpack("<HH", r[42:46])
        shdr.append(SampleHeader(name, start, end, sl, el, rate, okey,
                                 corr, link, stype))
    if shdr:
        shdr = shdr[:-1]  # terminal EOS record

    # --- instrument zones -> per-instrument region prototypes ---
    def inst_regions(inst_idx: int) -> List[Dict[int, int]]:
        if inst_idx + 1 >= len(inst):
            return []
        z0, z1 = inst[inst_idx][1], inst[inst_idx + 1][1]
        zones = [_zone_gens(ibag, igen, z) for z in range(z0, z1)]
        global_gens: Dict[int, int] = {}
        out = []
        for i, gens in enumerate(zones):
            gmap = dict(global_gens)
            has_sample = False
            for oper, amount in gens:
                gmap[oper] = amount
                if oper == G_SAMPLE_ID:
                    has_sample = True
            if not has_sample:
                if i == 0:   # global instrument zone
                    global_gens = gmap
                continue
            out.append(gmap)
        return out

    presets: List[Preset] = []
    for p in range(max(len(phdr) - 1, 0)):   # terminal EOP record
        name, patch, bank, bag0 = phdr[p]
        bag1 = phdr[p + 1][3]
        zones = [_zone_gens(pbag, pgen, z) for z in range(bag0, bag1)]
        global_p: Dict[int, int] = {}
        regions: List[Region] = []
        for i, gens in enumerate(zones):
            pmap = dict(global_p)
            has_inst = False
            for oper, amount in gens:
                pmap[oper] = amount
                if oper == G_INSTRUMENT:
                    has_inst = True
            if not has_inst:
                if i == 0:   # global preset zone
                    global_p = pmap
                continue
            pk_lo, pk_hi = _range(pmap.get(G_KEY_RANGE))
            pv_lo, pv_hi = _range(pmap.get(G_VEL_RANGE))
            for imap in inst_regions(pmap[G_INSTRUMENT]):
                ik_lo, ik_hi = _range(imap.get(G_KEY_RANGE))
                iv_lo, iv_hi = _range(imap.get(G_VEL_RANGE))
                k_lo, k_hi = max(pk_lo, ik_lo), min(pk_hi, ik_hi)
                v_lo, v_hi = max(pv_lo, iv_lo), min(pv_hi, iv_hi)
                if k_lo > k_hi or v_lo > v_hi:
                    continue
                sid = imap.get(G_SAMPLE_ID, 0)
                if sid >= len(shdr):
                    continue
                sh = shdr[sid]

                def val(op):
                    v = imap.get(op, _DEFAULTS[op])
                    if op in _PRESET_ADDITIVE and op in pmap:
                        v += pmap[op]
                    return v

                root = val(G_OVERRIDE_ROOT_KEY)
                if root < 0:
                    root = sh.original_key
                start = sh.start + val(G_START_OFFS) \
                    + 32768 * val(G_START_COARSE)
                end = sh.end + val(G_END_OFFS) + 32768 * val(G_END_COARSE)
                sloop = sh.start_loop + val(G_STARTLOOP_OFFS) \
                    + 32768 * val(G_STARTLOOP_COARSE)
                eloop = sh.end_loop + val(G_ENDLOOP_OFFS) \
                    + 32768 * val(G_ENDLOOP_COARSE)
                regions.append(Region(
                    key_lo=k_lo, key_hi=k_hi, vel_lo=v_lo, vel_hi=v_hi,
                    sample=sid,
                    sample_modes=imap.get(G_SAMPLE_MODES,
                                          _DEFAULTS[G_SAMPLE_MODES]),
                    root_key=root,
                    coarse_tune=val(G_COARSE_TUNE),
                    fine_tune=val(G_FINE_TUNE) + sh.correction,
                    scale_tuning=val(G_SCALE_TUNING),
                    pan=val(G_PAN),
                    initial_attenuation=val(G_INITIAL_ATTENUATION),
                    delay_vol_env=val(G_DELAY_VOL_ENV),
                    attack_vol_env=val(G_ATTACK_VOL_ENV),
                    hold_vol_env=val(G_HOLD_VOL_ENV),
                    decay_vol_env=val(G_DECAY_VOL_ENV),
                    sustain_vol_env=val(G_SUSTAIN_VOL_ENV),
                    release_vol_env=val(G_RELEASE_VOL_ENV),
                    initial_filter_fc=val(G_INITIAL_FILTER_FC),
                    initial_filter_q=val(G_INITIAL_FILTER_Q),
                    exclusive_class=imap.get(G_EXCLUSIVE_CLASS, 0),
                    start=start, end=end, start_loop=sloop, end_loop=eloop,
                    keynum_to_vol_hold=val(G_KEYNUM_TO_HOLD),
                    keynum_to_vol_decay=val(G_KEYNUM_TO_DECAY),
                    mod_lfo_to_pitch=val(G_MOD_LFO_TO_PITCH),
                    vib_lfo_to_pitch=val(G_VIB_LFO_TO_PITCH),
                    mod_env_to_pitch=val(G_MOD_ENV_TO_PITCH),
                    mod_lfo_to_filter_fc=val(G_MOD_LFO_TO_FILTER_FC),
                    mod_env_to_filter_fc=val(G_MOD_ENV_TO_FILTER_FC),
                    mod_lfo_to_volume=val(G_MOD_LFO_TO_VOLUME),
                    delay_mod_lfo=val(G_DELAY_MOD_LFO),
                    freq_mod_lfo=val(G_FREQ_MOD_LFO),
                    delay_vib_lfo=val(G_DELAY_VIB_LFO),
                    freq_vib_lfo=val(G_FREQ_VIB_LFO),
                    delay_mod_env=val(G_DELAY_MOD_ENV),
                    attack_mod_env=val(G_ATTACK_MOD_ENV),
                    hold_mod_env=val(G_HOLD_MOD_ENV),
                    decay_mod_env=val(G_DECAY_MOD_ENV),
                    sustain_mod_env=val(G_SUSTAIN_MOD_ENV),
                    release_mod_env=val(G_RELEASE_MOD_ENV),
                    keynum_to_mod_hold=val(G_KEYNUM_TO_MOD_HOLD),
                    keynum_to_mod_decay=val(G_KEYNUM_TO_MOD_DECAY),
                ))
        presets.append(Preset(name, bank, patch, tuple(regions)))

    return SoundFont(info=info, samples=samples,
                     sample_headers=tuple(shdr), presets=tuple(presets))


def _range(packed: Optional[int]) -> Tuple[int, int]:
    """keyRange/velRange amount: lo byte | hi byte (spec 8.1.2 fig. 43)."""
    if packed is None:
        return 0, 127
    u = packed & 0xFFFF
    return u & 0xFF, (u >> 8) & 0xFF
