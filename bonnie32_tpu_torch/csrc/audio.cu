// The tracker's two SPU recurrences, hand-written for Hopper (sm_90a).
// Built by bonnie32_tpu_torch/ops/_cuda.py with nvcc into a shared library
// with a plain C interface, loaded through ctypes by audio/reverb.py
// (`spu_reverb`) and audio/resampler.py (`spu_resample`).
//
// Neither replaces a Pallas kernel: the JAX package runs both as a
// per-sample `lax.scan` (an XLA while loop) outside any kernel.
//
//   spu_reverb   bonnie32_tpu/audio/reverb.py `process` (:75-198): the PS1
//                SPU reverb at its 22.05 kHz tick, Q15 saturating integer
//                arithmetic over two 0x20000-word circular work buffers.
//   spu_resample bonnie32_tpu/audio/resampler.py `process` (:58-102): the
//                SPU's downsample-by-averaging and 4-tap Gaussian
//                re-interpolation at 44.1 kHz.
//
// spu_reverb.  One stream is one chain: each tick reads words earlier
// ticks wrote (the IIR's feedback two ticks back, the others at least 19
// ticks back on most presets, as close as the same tick on ROOM, CHAOS_ECHO,
// DELAY and OFF).  What bounds it is that chain's latency on one thread,
// not bytes: the loop-carried path is the f32 accumulator's add, compare
// and subtract a sample and the IIR's ~8 integer steps every two ticks
// (chip_smoke.py's chain bound).  Design: one block a stream, so streams
// spread over the SMs.  Every address is pos + offset and pos moves by one
// a tick, so a window of W ticks touches at most 28 runs of W words, all
// known before it runs (reverb.py `window_layout`, passed as a table).
// The block stages those runs in shared memory with cp.async, while warp 1
// walks the accumulator to find the window's ticks; one thread then runs
// the chain over shared memory alone (a shared load is ~30 cycles, an L2
// round trip of the one-thread-a-stream design ~300): every read of a tick
// is loaded at its start, two ticks at a time where no read reaches a word
// of its own or the previous tick (`paired`), else one tick at a time with
// the tick's own writes forwarded in registers; the block writes the
// written runs back and mixes the window's outputs in parallel.  The
// buffers stay int32 in device memory, so the state compares word for
// word with the plain version.
//
// spu_resample.  Nothing chains through the data but each block's sum:
// where blocks end follows from the carried count alone, and the Gaussian
// index at sample i from the carried counter (bits 4-11 of pc0 + (i + 1) *
// pitch).  Design: blocks of kSegment samples; a thread sums each
// averaging block in order, then a thread per output reads the four newest
// averages from shared memory.  It is bound by its launch and its bytes.
//
// Numerics follow the JAX package op for op (built with -fmad=false, and
// the float steps written with the _rn intrinsics): no contraction, IEEE
// divides, its clamps' NaN propagation, XLA's f32 -> s32 convert (NaN -> 0)
// and its int32 multiply, which wraps: `mul_vol` multiplies as uint32 and
// casts back, never relying on signed overflow.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBuffer = 0x20000;   // reverb.py BUFFER_SIZE
constexpr int kParams = 32;        // preset registers (reverb.py _IDX)

// The register layout of reverb.py `_IDX`.
enum Reg {
  D_APF1 = 0, D_APF2, V_IIR, V_COMB1, V_COMB2, V_COMB3, V_COMB4, V_WALL,
  V_APF1, V_APF2, M_L_SAME, M_R_SAME, M_L_COMB1, M_R_COMB1, M_L_COMB2,
  M_R_COMB2, D_L_SAME, D_R_SAME, M_L_DIFF, M_R_DIFF, M_L_COMB3, M_R_COMB3,
  M_L_COMB4, M_R_COMB4, D_L_DIFF, D_R_DIFF, M_L_APF1, M_R_APF1, M_L_APF2,
  M_R_APF2, V_L_IN, V_R_IN
};

// The PS1 SPU's 512-entry Gaussian interpolation ROM: a copy of
// bonnie32_tpu_torch/audio/spu_tables.py GAUSSIAN_TABLE
// (tests/test_torch_audio.py holds the two equal).
__constant__ int kGauss[512] = {
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 1,
    1, 1, 1, 2, 2, 2, 3, 3, 3, 4, 4, 5,
    5, 6, 7, 7, 8, 9, 9, 10, 11, 12, 13, 14,
    15, 16, 17, 18, 19, 21, 22, 24, 25, 27, 28, 30,
    32, 33, 35, 37, 39, 41, 44, 46, 48, 51, 53, 56,
    58, 61, 64, 67, 70, 73, 77, 80, 84, 87, 91, 95,
    99, 103, 107, 111, 116, 120, 125, 130, 135, 140, 145, 150,
    156, 161, 167, 173, 179, 186, 192, 199, 205, 212, 219, 227,
    234, 242, 250, 257, 266, 274, 283, 291, 300, 309, 319, 328,
    338, 348, 358, 369, 379, 390, 401, 412, 424, 436, 448, 460,
    473, 485, 498, 512, 525, 539, 553, 567, 582, 597, 612, 627,
    643, 659, 675, 692, 708, 726, 743, 761, 779, 797, 816, 835,
    854, 874, 894, 914, 935, 956, 977, 999, 1020, 1043, 1066, 1089,
    1112, 1136, 1160, 1184, 1209, 1234, 1260, 1286, 1312, 1339, 1366, 1394,
    1422, 1450, 1479, 1508, 1537, 1567, 1598, 1628, 1660, 1691, 1723, 1756,
    1789, 1822, 1856, 1890, 1924, 1959, 1995, 2031, 2067, 2104, 2141, 2179,
    2217, 2256, 2295, 2334, 2374, 2415, 2456, 2497, 2539, 2582, 2624, 2668,
    2712, 2756, 2801, 2846, 2892, 2938, 2985, 3032, 3079, 3128, 3176, 3225,
    3275, 3325, 3376, 3427, 3479, 3531, 3584, 3637, 3691, 3745, 3799, 3855,
    3910, 3967, 4023, 4081, 4138, 4197, 4255, 4315, 4374, 4435, 4495, 4557,
    4619, 4681, 4744, 4807, 4871, 4935, 5000, 5065, 5131, 5197, 5264, 5332,
    5399, 5468, 5536, 5606, 5676, 5746, 5817, 5888, 5959, 6032, 6104, 6177,
    6251, 6325, 6400, 6475, 6550, 6626, 6702, 6779, 6856, 6934, 7012, 7091,
    7170, 7249, 7329, 7409, 7490, 7571, 7653, 7735, 7817, 7900, 7983, 8066,
    8150, 8234, 8319, 8404, 8489, 8575, 8661, 8748, 8834, 8922, 9009, 9097,
    9185, 9273, 9362, 9451, 9541, 9630, 9720, 9811, 9901, 9992, 10083, 10174,
    10266, 10358, 10450, 10542, 10635, 10727, 10820, 10913, 11007, 11100, 11194, 11288,
    11382, 11476, 11571, 11665, 11760, 11855, 11950, 12045, 12140, 12236, 12331, 12427,
    12522, 12618, 12714, 12809, 12905, 13001, 13097, 13193, 13289, 13385, 13481, 13577,
    13673, 13769, 13865, 13961, 14056, 14152, 14248, 14343, 14439, 14534, 14630, 14725,
    14820, 14915, 15010, 15104, 15199, 15293, 15387, 15481, 15575, 15669, 15762, 15855,
    15948, 16041, 16133, 16226, 16317, 16409, 16500, 16592, 16682, 16773, 16863, 16953,
    17042, 17131, 17220, 17308, 17396, 17484, 17571, 17658, 17744, 17830, 17916, 18001,
    18086, 18170, 18254, 18337, 18420, 18502, 18584, 18665, 18746, 18826, 18905, 18985,
    19063, 19141, 19219, 19295, 19372, 19447, 19522, 19597, 19671, 19744, 19816, 19888,
    19959, 20030, 20100, 20169, 20238, 20306, 20373, 20439, 20505, 20570, 20634, 20698,
    20760, 20822, 20884, 20944, 21004, 21063, 21121, 21178, 21235, 21290, 21345, 21399,
    21452, 21505, 21556, 21607, 21657, 21706, 21754, 21801, 21848, 21893, 21938, 21982,
    22025, 22066, 22107, 22148, 22187, 22225, 22262, 22299, 22334, 22369, 22402, 22435,
    22467, 22498, 22527, 22556, 22584, 22611, 22637, 22662, 22686, 22709, 22731, 22752,
    22772, 22791, 22809, 22826, 22842, 22857, 22872, 22885, 22897, 22908, 22918, 22927,
    22935, 22942, 22948, 22953, 22957, 22960, 22962, 22963};

__device__ __forceinline__ int clamp16(int x) {
  return min(max(x, -32768), 32767);
}

// (sample * volume) >> 15, clamped to i16, with the product wrapped to
// 32 bits as XLA's int32 multiply wraps it (reverb.py _mul_vol).
__device__ __forceinline__ int mul_vol(int sample, int volume) {
  const int prod = (int)((uint32_t)sample * (uint32_t)volume);
  return clamp16(prod >> 15);
}

// jnp.clip(x, lo, hi) = minimum(maximum(x, lo), hi): NaN stays NaN.
__device__ __forceinline__ float clipf(float x, float lo, float hi) {
  return x != x ? x : fminf(fmaxf(x, lo), hi);
}

// clip(trunc(x * 32767), -32768, 32767).astype(int32), NaN -> 0.
__device__ __forceinline__ int to_q15(float x) {
  const float t = clipf(truncf(__fmul_rn(x, 32767.0f)), -32768.0f,
                        32767.0f);
  return t != t ? 0 : (int)t;
}

// A window's layout (reverb.py `layout_table`), one table a stream.
constexpr int kSideSlots = 14;
enum LayoutWord {
  LW_WORDS = 0,             // shared words of side 0 (buffer_l), side 1
  LW_RUNS = 2,              // runs of side 0, side 1
  LW_PAIRED = 4,            // two ticks may load before either stores
  LW_SLOTS = 5,             // 14 slots a side
  LW_RUN_TABLE = 33,        // 14 runs a side: start, length, base, written
  kLayoutWords = LW_RUN_TABLE + 2 * kSideSlots * 4
};

// The accesses of one tick to one side's buffer (reverb.py
// `_SIDE_ACCESS`): slot k of the tick at t is shared word slot[k] + t.
enum Slot {
  S_D_SAME = 0, S_SAME_PREV, S_SAME, S_DIFF_PREV, S_DIFF, S_D_DIFF,
  S_COMB1, S_COMB2, S_COMB3, S_COMB4, S_APF1_PREV, S_APF1, S_APF2_PREV,
  S_APF2
};

__device__ __forceinline__ bool is_write(int k) {
  return k == S_SAME || k == S_DIFF || k == S_APF1 || k == S_APF2;
}

constexpr int kReverbThreads = 128;
constexpr int kScheduleThread = 32;    // warp 1 walks the accumulator

// Copy a side's runs between its buffer and shared memory: into shared
// memory with cp.async (every word in flight at once), or back, runs
// that hold a write only.
__device__ __forceinline__ void stage_in(int* sh, const int* buf,
                                         const int* runs, int nruns,
                                         int pos) {
  for (int r = 0; r < nruns; ++r) {
    const int start = runs[4 * r], len = runs[4 * r + 1];
    int* dst = sh + runs[4 * r + 2];
    for (int j = threadIdx.x; j < len; j += blockDim.x)
      __pipeline_memcpy_async(
          dst + j,
          buf + (((uint32_t)pos + (uint32_t)(start + j)) & (kBuffer - 1)),
          sizeof(int));
  }
}

__device__ __forceinline__ void stage_out(const int* sh, int* buf,
                                          const int* runs, int nruns,
                                          int pos) {
  for (int r = 0; r < nruns; ++r) {
    if (!runs[4 * r + 3]) continue;
    const int start = runs[4 * r], len = runs[4 * r + 1];
    const int* src = sh + runs[4 * r + 2];
#pragma unroll 4
    for (int j = threadIdx.x; j < len; j += blockDim.x)
      buf[((uint32_t)pos + (uint32_t)(start + j)) & (kBuffer - 1)] = src[j];
  }
}

struct Volumes {
  int wall, iir, apf1, apf2, comb[4];
};

// Which reads see a write of their own side made earlier in the same
// tick (same slot; reverb.py `_EARLIER_WRITES`).
struct Aliases {
  bool rdd_rs, ldp_ls, ldd_ls, ldd_ld, rdp_rs;
  bool lc_s[4], lc_d[4], rc_s[4], rc_d[4];
  bool la1_s, la1_d, ra1_s, ra1_d, la2_s, la2_d, la2_1, ra2_s, ra2_d, ra2_1;
};

// One tick's words: the reads of each side by slot (write slots unused).
struct TickWords {
  int l[kSideSlots], r[kSideSlots];
};

// Every read of a tick, as the words stood before its first store.
__device__ __forceinline__ void load_tick(TickWords& a, int* const* pl,
                                          int* const* pr, int t) {
#pragma unroll
  for (int k = 0; k < kSideSlots; ++k) {
    if (is_write(k)) continue;
    a.l[k] = pl[k][t];
    a.r[k] = pr[k][t];
  }
}

// sample22k (reverb.py:93-164) on the words `a` loaded at the tick's
// start; with kForward, a read that a write before it in the tick
// reached takes the written value instead.  Stores the tick's writes at
// tick t of the slot pointers and returns its clamped outputs.
template <bool kForward>
__device__ __forceinline__ void tick_chain(const TickWords& a, int l_in,
                                           int r_in, const Volumes& v,
                                           const Aliases& f,
                                           int* const* pl, int* const* pr,
                                           int t, int& out_l, int& out_r) {
  auto fw = [](int x, bool same, int w) {
    return kForward && same ? w : x;
  };
  // same-side reflections
  int prev = a.l[S_SAME_PREV];
  int in = l_in + mul_vol(a.l[S_D_SAME], v.wall);
  const int w_ls = clamp16(mul_vol(in - prev, v.iir) + prev);
  pl[S_SAME][t] = w_ls;
  prev = a.r[S_SAME_PREV];
  in = r_in + mul_vol(a.r[S_D_SAME], v.wall);
  const int w_rs = clamp16(mul_vol(in - prev, v.iir) + prev);
  pr[S_SAME][t] = w_rs;

  // different-side reflections
  const int d_r_diff = fw(a.r[S_D_DIFF], f.rdd_rs, w_rs);
  prev = fw(a.l[S_DIFF_PREV], f.ldp_ls, w_ls);
  in = l_in + mul_vol(d_r_diff, v.wall);
  const int w_ld = clamp16(mul_vol(in - prev, v.iir) + prev);
  pl[S_DIFF][t] = w_ld;
  const int d_l_diff = fw(fw(a.l[S_D_DIFF], f.ldd_ls, w_ls), f.ldd_ld, w_ld);
  prev = fw(a.r[S_DIFF_PREV], f.rdp_rs, w_rs);
  in = r_in + mul_vol(d_l_diff, v.wall);
  const int w_rd = clamp16(mul_vol(in - prev, v.iir) + prev);
  pr[S_DIFF][t] = w_rd;

  // comb filters
  int lo = 0, ro = 0;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    lo += mul_vol(fw(fw(a.l[S_COMB1 + c], f.lc_s[c], w_ls), f.lc_d[c], w_ld),
                  v.comb[c]);
    ro += mul_vol(fw(fw(a.r[S_COMB1 + c], f.rc_s[c], w_rs), f.rc_d[c], w_rd),
                  v.comb[c]);
  }

  // all-pass 1, left then right
  int ap = fw(fw(a.l[S_APF1_PREV], f.la1_s, w_ls), f.la1_d, w_ld);
  lo = lo - mul_vol(ap, v.apf1);
  const int w_la1 = clamp16(lo);
  pl[S_APF1][t] = w_la1;
  lo = mul_vol(lo, v.apf1) + ap;
  ap = fw(fw(a.r[S_APF1_PREV], f.ra1_s, w_rs), f.ra1_d, w_rd);
  ro = ro - mul_vol(ap, v.apf1);
  const int w_ra1 = clamp16(ro);
  pr[S_APF1][t] = w_ra1;
  ro = mul_vol(ro, v.apf1) + ap;

  // all-pass 2, left then right
  ap = fw(fw(fw(a.l[S_APF2_PREV], f.la2_s, w_ls), f.la2_d, w_ld), f.la2_1,
          w_la1);
  lo = lo - mul_vol(ap, v.apf2);
  pl[S_APF2][t] = clamp16(lo);
  lo = mul_vol(lo, v.apf2) + ap;
  ap = fw(fw(fw(a.r[S_APF2_PREV], f.ra2_s, w_rs), f.ra2_d, w_rd), f.ra2_1,
          w_ra1);
  ro = ro - mul_vol(ap, v.apf2);
  pr[S_APF2][t] = clamp16(ro);
  ro = mul_vol(ro, v.apf2) + ap;

  out_l = clamp16(lo);
  out_r = clamp16(ro);
}

// One block a stream.  For each window of at most `window` ticks and
// `window_samples` samples:
//   1. the block stages the runs of both buffers and the window's inputs
//      in shared memory (cp.async); meanwhile warp 1 walks the f32
//      accumulator over the samples: which sample each tick falls on;
//   2. the block converts each tick's inputs to Q15;
//   3. thread 0 runs the ticks' chain over shared memory alone, two
//      ticks a step where the layout allows it (`paired`), else one tick
//      a step with its own writes forwarded to its later reads;
//   4. the block writes the written runs back and mixes the outputs.
__global__ void __launch_bounds__(kReverbThreads)
spu_reverb_kernel(int* __restrict__ buf_l, int* __restrict__ buf_r,
                  int* __restrict__ pos_io, float* __restrict__ accum_io,
                  const int* __restrict__ params,
                  const int* __restrict__ layouts,
                  const float* __restrict__ left,
                  const float* __restrict__ right,
                  float* __restrict__ out_l, float* __restrict__ out_r,
                  int n, float wet, float dry, float vol, float inc,
                  int enabled, int window, int window_samples) {
  extern __shared__ int smem[];
  __shared__ int pos_sh, used_sh, ticks_sh;
  __shared__ float accum_sh;
  const int s = blockIdx.x;
  const int tid = threadIdx.x;
  const int* lay = layouts + (size_t)s * kLayoutWords;
  const int* p = params + (size_t)s * kParams;
  // per sample: its inputs, the tick that falls on it (-1: none); per
  // tick: its sample, its Q15 inputs, then its outputs
  float* x_l = reinterpret_cast<float*>(smem);
  float* x_r = x_l + window_samples;
  int* tick_of = smem + 2 * window_samples;
  int* tick_at = tick_of + window_samples;
  int* tick_l = tick_at + window;
  int* tick_r = tick_l + window;
  int* sl = tick_r + window;
  int* sr = sl + lay[LW_WORDS];
  int* bl = buf_l + (size_t)s * kBuffer;
  int* br = buf_r + (size_t)s * kBuffer;
  const float* xl = left + (size_t)s * n;
  const float* xr = right + (size_t)s * n;
  const int* runs_l = lay + LW_RUN_TABLE;
  const int* runs_r = lay + LW_RUN_TABLE + kSideSlots * 4;
  if (tid == 0) {
    pos_sh = pos_io[s];
    accum_sh = accum_io[s];
  }
  __syncthreads();

  for (int i0 = 0; i0 < n;) {
    const int pos0 = pos_sh;
    const int len = min(window_samples, n - i0);
    stage_in(sl, bl, runs_l, lay[LW_RUNS], pos0);
    stage_in(sr, br, runs_r, lay[LW_RUNS + 1], pos0);
    for (int j = tid; j < len; j += blockDim.x) {
      __pipeline_memcpy_async(x_l + j, xl + i0 + j, sizeof(float));
      __pipeline_memcpy_async(x_r + j, xr + i0 + j, sizeof(float));
    }
    __pipeline_commit();
    if (tid == kScheduleThread) {
      float accum = accum_sh;
      int ticks = 0, j = 0;
      for (; j < len && ticks < window; ++j) {
        accum = __fadd_rn(accum, inc);
        int k = -1;
        if (accum >= 1.0f) {
          k = ticks++;
          tick_at[k] = j;
          accum = __fsub_rn(accum, 1.0f);
        }
        tick_of[j] = k;
      }
      used_sh = j;
      ticks_sh = ticks;
      accum_sh = accum;
    }
    __pipeline_wait_prior(0);
    __syncthreads();

    const int ticks = ticks_sh;
    for (int k = tid; k < ticks; k += blockDim.x) {
      tick_l[k] = mul_vol(to_q15(x_l[tick_at[k]]), p[V_L_IN]);
      tick_r[k] = mul_vol(to_q15(x_r[tick_at[k]]), p[V_R_IN]);
    }
    __syncthreads();

    if (tid == 0) {
      int* pl[kSideSlots];
      int* pr[kSideSlots];
#pragma unroll
      for (int k = 0; k < kSideSlots; ++k) {
        pl[k] = sl + lay[LW_SLOTS + k];
        pr[k] = sr + lay[LW_SLOTS + kSideSlots + k];
      }
      const Volumes v{p[V_WALL], p[V_IIR], p[V_APF1], p[V_APF2],
                      {p[V_COMB1], p[V_COMB2], p[V_COMB3], p[V_COMB4]}};
      if (lay[LW_PAIRED]) {
        const Aliases none{};
        int k = 0;
        for (; k + 1 < ticks; k += 2) {
          TickWords a, b;
          load_tick(a, pl, pr, 0);
          load_tick(b, pl, pr, 1);
          const int a_l = tick_l[k], a_r = tick_r[k];
          const int b_l = tick_l[k + 1], b_r = tick_r[k + 1];
          tick_chain<false>(a, a_l, a_r, v, none, pl, pr, 0, tick_l[k],
                            tick_r[k]);
          tick_chain<false>(b, b_l, b_r, v, none, pl, pr, 1,
                            tick_l[k + 1], tick_r[k + 1]);
#pragma unroll
          for (int q = 0; q < kSideSlots; ++q) {
            pl[q] += 2;
            pr[q] += 2;
          }
        }
        if (k < ticks) {
          TickWords a;
          load_tick(a, pl, pr, 0);
          tick_chain<false>(a, tick_l[k], tick_r[k], v, none, pl, pr, 0,
                            tick_l[k], tick_r[k]);
        }
      } else {
        auto same = [&](int side, int read, int write) {
          return lay[LW_SLOTS + side * kSideSlots + read]
                 == lay[LW_SLOTS + side * kSideSlots + write];
        };
        Aliases f;
        f.rdd_rs = same(1, S_D_DIFF, S_SAME);
        f.ldp_ls = same(0, S_DIFF_PREV, S_SAME);
        f.ldd_ls = same(0, S_D_DIFF, S_SAME);
        f.ldd_ld = same(0, S_D_DIFF, S_DIFF);
        f.rdp_rs = same(1, S_DIFF_PREV, S_SAME);
        for (int c = 0; c < 4; ++c) {
          f.lc_s[c] = same(0, S_COMB1 + c, S_SAME);
          f.lc_d[c] = same(0, S_COMB1 + c, S_DIFF);
          f.rc_s[c] = same(1, S_COMB1 + c, S_SAME);
          f.rc_d[c] = same(1, S_COMB1 + c, S_DIFF);
        }
        f.la1_s = same(0, S_APF1_PREV, S_SAME);
        f.la1_d = same(0, S_APF1_PREV, S_DIFF);
        f.ra1_s = same(1, S_APF1_PREV, S_SAME);
        f.ra1_d = same(1, S_APF1_PREV, S_DIFF);
        f.la2_s = same(0, S_APF2_PREV, S_SAME);
        f.la2_d = same(0, S_APF2_PREV, S_DIFF);
        f.la2_1 = same(0, S_APF2_PREV, S_APF1);
        f.ra2_s = same(1, S_APF2_PREV, S_SAME);
        f.ra2_d = same(1, S_APF2_PREV, S_DIFF);
        f.ra2_1 = same(1, S_APF2_PREV, S_APF1);
        for (int k = 0; k < ticks; ++k) {
          TickWords a;
          load_tick(a, pl, pr, 0);
          tick_chain<true>(a, tick_l[k], tick_r[k], v, f, pl, pr, 0,
                           tick_l[k], tick_r[k]);
#pragma unroll
          for (int q = 0; q < kSideSlots; ++q) {
            ++pl[q];
            ++pr[q];
          }
        }
      }
      if (ticks) pos_sh = (pos0 + ticks) & (kBuffer - 1);
    }
    __syncthreads();

    const int used = used_sh;
    stage_out(sl, bl, runs_l, lay[LW_RUNS], pos0);
    stage_out(sr, br, runs_r, lay[LW_RUNS + 1], pos0);
    for (int j = tid; j < used; j += blockDim.x) {
      const size_t at = (size_t)s * n + i0 + j;
      const float l = x_l[j], r = x_r[j];
      const int k = tick_of[j];
      float ol = l, orr = r;
      if (enabled && k >= 0) {
        // (x * dry + (last / 32767) * wet) * vol, uncontracted
        const float lw = __fdiv_rn((float)tick_l[k], 32767.0f);
        const float rw = __fdiv_rn((float)tick_r[k], 32767.0f);
        ol = __fmul_rn(__fadd_rn(__fmul_rn(l, dry), __fmul_rn(lw, wet)),
                       vol);
        orr = __fmul_rn(__fadd_rn(__fmul_rn(r, dry), __fmul_rn(rw, wet)),
                        vol);
      }
      out_l[at] = ol;
      out_r[at] = orr;
    }
    i0 += used;
    __syncthreads();
  }
  if (tid == 0) {
    pos_io[s] = pos_sh;
    accum_io[s] = accum_sh;
  }
}

// resampler.py _gauss: ((g0*s0 + g1*s1) + g2*s2) + g3*s3, then / 32768,
// the taps from the block's shared copy of the ROM.
__device__ __forceinline__ float gauss(const int* rom, float s0, float s1,
                                       float s2, float s3, int idx) {
  const float g0 = (float)rom[0xFF - idx];
  const float g1 = (float)rom[0x1FF - idx];
  const float g2 = (float)rom[0x100 + idx];
  const float g3 = (float)rom[idx];
  float acc = __fadd_rn(__fmul_rn(g0, s0), __fmul_rn(g1, s1));
  acc = __fadd_rn(acc, __fmul_rn(g2, s2));
  acc = __fadd_rn(acc, __fmul_rn(g3, s3));
  return __fdiv_rn(acc, 32768.0f);
}

constexpr int kSegment = 1024;         // samples a resampler block
constexpr int kResampleThreads = 256;
// history entries a segment reads: its blocks (ratio >= 1) and four more
constexpr int kSeqSlots = kSegment + 8;

// The carried state of one stream, as every block of it reads it.
struct ResampleState {
  float hl[4], hr[4], al, ar;
  int pc, count;
};

// Block k's sum of one side: its samples in order, from the carried sum
// for the first block (which starts the call) and from 0 for the others;
// the tail block (k = pushes) stops at n.
__device__ __forceinline__ float block_sum(const float* x, float carried,
                                           int k, int first, int ratio,
                                           int n) {
  const int end = first + k * ratio;
  float acc = k == 0 ? carried : 0.0f;
  for (int j = max(0, end - ratio + 1); j <= end && j < n; ++j)
    acc = __fadd_rn(acc, x[j]);
  return acc;
}

__device__ __forceinline__ float block_avg(float sum, int k, int first,
                                           int ratio, int count0) {
  const float cnt = (float)(k == 0 ? count0 + first + 1 : ratio);
  return clipf(__fdiv_rn(sum, cnt), -1.5f, 1.5f);
}

// Sequence entry j of one side: the carried history for j < 4, then the
// average of block j - 4.
__device__ __forceinline__ float seq_entry(const float* x, const float* h,
                                           float carried, int j, int first,
                                           int ratio, int n, int count0) {
  if (j < 4) return h[j];
  const int k = j - 4;
  return block_avg(block_sum(x, carried, k, first, ratio, n), k, first,
                   ratio, count0);
}

// grid (segments, streams): block (g, s) writes outputs
// [g * kSegment, (g + 1) * kSegment) of stream s.  Every block reads the
// carried state; the last block of a stream to finish (a ticket counter,
// reset by it) writes the new one, so no block reads a state another
// has written.
__global__ void __launch_bounds__(kResampleThreads)
spu_resample_kernel(float* __restrict__ hist_l, float* __restrict__ hist_r,
                    int* __restrict__ pc_io, float* __restrict__ acc_l_io,
                    float* __restrict__ acc_r_io, int* __restrict__ cnt_io,
                    const float* __restrict__ left,
                    const float* __restrict__ right,
                    float* __restrict__ out_l, float* __restrict__ out_r,
                    int* __restrict__ tickets, int n, int pitch, int ratio,
                    int enabled) {
  __shared__ int rom[512];
  __shared__ float seq_l[kSeqSlots], seq_r[kSeqSlots];
  __shared__ ResampleState st;
  __shared__ bool writes_state;
  const int s = blockIdx.y;
  const int tid = threadIdx.x;
  const float* xl = left + (size_t)s * n;
  const float* xr = right + (size_t)s * n;
  for (int k = tid; k < 512; k += blockDim.x) rom[k] = kGauss[k];
  if (tid == 0) {
    for (int k = 0; k < 4; ++k) {
      st.hl[k] = hist_l[4 * s + k];
      st.hr[k] = hist_r[4 * s + k];
    }
    st.al = acc_l_io[s];
    st.ar = acc_r_io[s];
    st.pc = pc_io[s];
    st.count = cnt_io[s];
  }
  __syncthreads();

  const int count0 = st.count;
  const int first = max(0, ratio - count0 - 1);   // sample of the 1st push
  // pushes up to and including sample i: the newest sequence entry at i
  // is `newest(i) + 3`
  auto newest = [&](int i) {
    return i >= first ? (i - first) / ratio + 1 : 0;
  };
  const int i0 = blockIdx.x * kSegment;
  const int i1 = min(n, i0 + kSegment);
  const int j0 = newest(i0);
  const int j1 = newest(i1 - 1) + 4;               // exclusive
  for (int j = j0 + tid; j < j1; j += blockDim.x) {
    seq_l[j - j0] = seq_entry(xl, st.hl, st.al, j, first, ratio, n, count0);
    seq_r[j - j0] = seq_entry(xr, st.hr, st.ar, j, first, ratio, n, count0);
  }
  __syncthreads();

  for (int i = i0 + tid; i < i1; i += blockDim.x) {
    const int m = newest(i) - j0;
    const int idx = (int)((((uint32_t)st.pc
                            + (uint32_t)(i + 1) * (uint32_t)pitch) >> 4)
                          & 0xFF);
    const float gl = clipf(gauss(rom, seq_l[m], seq_l[m + 1], seq_l[m + 2],
                                 seq_l[m + 3], idx), -1.5f, 1.5f);
    const float gr = clipf(gauss(rom, seq_r[m], seq_r[m + 1], seq_r[m + 2],
                                 seq_r[m + 3], idx), -1.5f, 1.5f);
    const size_t at = (size_t)s * n + i;
    out_l[at] = enabled ? gl : xl[i];
    out_r[at] = enabled ? gr : xr[i];
  }

  __syncthreads();
  if (tid == 0) {
    if (gridDim.x == 1) {
      writes_state = true;
    } else {
      __threadfence();
      writes_state = atomicAdd(&tickets[s], 1) == (int)gridDim.x - 1;
      if (writes_state) tickets[s] = 0;
    }
  }
  __syncthreads();
  if (!writes_state) return;
  // the new state: the four newest entries, the tail's sums and count,
  // the counter after n samples
  const int pushes = newest(n - 1);
  if (tid < 4) {
    const int j = pushes + tid;
    hist_l[4 * s + tid] = seq_entry(xl, st.hl, st.al, j, first, ratio, n,
                                    count0);
    hist_r[4 * s + tid] = seq_entry(xr, st.hr, st.ar, j, first, ratio, n,
                                    count0);
  } else if (tid == 4) {
    acc_l_io[s] = block_sum(xl, st.al, pushes, first, ratio, n);
    acc_r_io[s] = block_sum(xr, st.ar, pushes, first, ratio, n);
    cnt_io[s] = pushes == 0 ? count0 + n
                            : n - 1 - (first + (pushes - 1) * ratio);
    const long long final_pc = (long long)st.pc + (long long)n * pitch;
    pc_io[s] = (int)(final_pc >= 0x1000 ? (final_pc & 0xFFF) : final_pc);
  }
}

}  // namespace

// Both entry points update the state arrays in place (the wrappers pass
// copies unless the caller gives its state up), write the (streams, n)
// outputs, launch on `stream` and return the launch's CUDA error (0:
// none).

// `layouts`: (streams, kLayoutWords) int32, reverb.py `layout_table`
// for `window`; `shared_bytes`: the largest stream's dynamic shared
// memory (reverb.py `shared_bytes`).
extern "C" int spu_reverb(int* buf_l, int* buf_r, int* pos, float* accum,
                          const int* params, const int* layouts,
                          const float* left, const float* right,
                          float* out_l, float* out_r, int streams, int n,
                          float wet, float dry, float vol, float inc,
                          int enabled, int window, int window_samples,
                          int shared_bytes, void* stream) {
  if (streams <= 0 || n <= 0) return 0;
  if (window <= 0 || window_samples <= 0) return (int)cudaErrorInvalidValue;
  if (shared_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        spu_reverb_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        shared_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  spu_reverb_kernel<<<streams, kReverbThreads, shared_bytes,
                      (cudaStream_t)stream>>>(
      buf_l, buf_r, pos, accum, params, layouts, left, right, out_l, out_r,
      n, wet, dry, vol, inc, enabled, window, window_samples);
  return (int)cudaGetLastError();
}

// `tickets`: (streams,) int32 zeros where n spans more than one segment
// (the kernel leaves them zero), else unused.
extern "C" int spu_resample(float* hist_l, float* hist_r, int* pc,
                            float* acc_l, float* acc_r, int* cnt,
                            const float* left, const float* right,
                            float* out_l, float* out_r, int streams, int n,
                            int pitch, int ratio, int enabled, int* tickets,
                            void* stream) {
  if (streams <= 0 || n <= 0) return 0;
  if (ratio <= 0 || streams > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((n + kSegment - 1) / kSegment, streams);
  if (grid.x > 1 && tickets == nullptr) return (int)cudaErrorInvalidValue;
  spu_resample_kernel<<<grid, kResampleThreads, 0, (cudaStream_t)stream>>>(
      hist_l, hist_r, pc, acc_l, acc_r, cnt, left, right, out_l, out_r,
      tickets, n, pitch, ratio, enabled);
  return (int)cudaGetLastError();
}
