// The tracker's two SPU recurrences, hand-written for Hopper (sm_90a).
// Built by bonnie32_tpu_torch/ops/_cuda.py with nvcc into a shared library
// with a plain C interface, loaded through ctypes by audio/reverb.py
// (`spu_reverb`) and audio/resampler.py (`spu_resample`).
//
// Neither replaces a Pallas kernel: the JAX package runs both as a
// per-sample `lax.scan` (an XLA while loop) outside any kernel.  In eager
// torch a scan is a Python loop of some hundred launches a sample, so each
// becomes one kernel that walks the samples itself.
//
//   spu_reverb   bonnie32_tpu/audio/reverb.py `process` (:75-198): the PS1
//                SPU reverb at its 22.05 kHz tick, Q15 saturating integer
//                arithmetic over two 0x20000-word circular work buffers.
//   spu_resample bonnie32_tpu/audio/resampler.py `process` (:58-102): the
//                SPU's downsample-by-averaging and 4-tap Gaussian
//                re-interpolation at 44.1 kHz.
//
// Design: one thread a stream, looping over the chunk's samples in order.
// A stream is one serial dependency chain (every tick reads what earlier
// ticks wrote), so no two samples of a stream can run at once; streams are
// independent, and a batch of them fills a block.  What bounds a single
// stream on the H100 is therefore the latency of that chain — the reverb's
// reads of its work buffers after its own writes (L1/L2 round trips), the
// resampler's few dependent float operations a sample — not bytes or
// operations; chip_smoke.py prints the ns per 22.05 kHz tick beside the
// bytes bound.  The reverb's work buffers stay int32 in device memory (1
// MiB a stream, too large for shared memory), so the state equals the
// plain version's word for word; the resampler's state lives in registers.
//
// Numerics follow the JAX package op for op (built with -fmad=false, and
// the float steps written with the _rn intrinsics): no contraction, IEEE
// divides, its clamps' NaN propagation, XLA's f32 -> s32 convert (NaN -> 0)
// and its int32 multiply, which wraps: `mul_vol` multiplies as uint32 and
// casts back, never relying on signed overflow.

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

struct Buf {
  int* b;
  int pos;
  // (pos + off) % BUFFER_SIZE on int32 that wraps: BUFFER_SIZE divides
  // 2^32, so an unsigned add and a mask give the same index.
  __device__ __forceinline__ int& at(int off) const {
    return b[((uint32_t)pos + (uint32_t)off) & (kBuffer - 1)];
  }
};

__global__ void __launch_bounds__(64)
spu_reverb_kernel(int* __restrict__ buf_l, int* __restrict__ buf_r,
                  int* __restrict__ pos_io, float* __restrict__ accum_io,
                  const int* __restrict__ params,
                  const float* __restrict__ left,
                  const float* __restrict__ right,
                  float* __restrict__ out_l, float* __restrict__ out_r,
                  int streams, int n, float wet, float dry, float vol,
                  float inc, int enabled) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= streams) return;
  int p[kParams];
#pragma unroll
  for (int k = 0; k < kParams; ++k) p[k] = params[s * kParams + k];
  const int m_l_same_prev = (p[M_L_SAME] - 2) & 0xFFFF;
  const int m_r_same_prev = (p[M_R_SAME] - 2) & 0xFFFF;
  const int m_l_diff_prev = (p[M_L_DIFF] - 2) & 0xFFFF;
  const int m_r_diff_prev = (p[M_R_DIFF] - 2) & 0xFFFF;
  const int l_apf1 = (p[M_L_APF1] - p[D_APF1]) & 0xFFFF;
  const int r_apf1 = (p[M_R_APF1] - p[D_APF1]) & 0xFFFF;
  const int l_apf2 = (p[M_L_APF2] - p[D_APF2]) & 0xFFFF;
  const int r_apf2 = (p[M_R_APF2] - p[D_APF2]) & 0xFFFF;

  Buf bl{buf_l + (size_t)s * kBuffer, pos_io[s]};
  Buf br{buf_r + (size_t)s * kBuffer, pos_io[s]};
  float accum = accum_io[s];
  int last_l = 0, last_r = 0;
  const size_t row = (size_t)s * n;
  for (int i = 0; i < n; ++i) {
    const float l = left[row + i], r = right[row + i];
    accum = __fadd_rn(accum, inc);
    const bool ticked = accum >= 1.0f;
    if (ticked) {
      // sample22k (reverb.py:93-164), reads and writes in its order: a
      // read after a write of the same buffer may hit the word just
      // written.
      const int l_in = mul_vol(to_q15(l), p[V_L_IN]);
      const int r_in = mul_vol(to_q15(r), p[V_R_IN]);

      // same-side reflections
      int prev = bl.at(m_l_same_prev);
      int in = l_in + mul_vol(bl.at(p[D_L_SAME]), p[V_WALL]);
      bl.at(p[M_L_SAME]) = clamp16(mul_vol(in - prev, p[V_IIR]) + prev);

      prev = br.at(m_r_same_prev);
      in = r_in + mul_vol(br.at(p[D_R_SAME]), p[V_WALL]);
      br.at(p[M_R_SAME]) = clamp16(mul_vol(in - prev, p[V_IIR]) + prev);

      // different-side reflections
      const int d_r_diff = br.at(p[D_R_DIFF]);
      prev = bl.at(m_l_diff_prev);
      in = l_in + mul_vol(d_r_diff, p[V_WALL]);
      bl.at(p[M_L_DIFF]) = clamp16(mul_vol(in - prev, p[V_IIR]) + prev);

      const int d_l_diff = bl.at(p[D_L_DIFF]);
      prev = br.at(m_r_diff_prev);
      in = r_in + mul_vol(d_l_diff, p[V_WALL]);
      br.at(p[M_R_DIFF]) = clamp16(mul_vol(in - prev, p[V_IIR]) + prev);

      // comb filters
      int lo = mul_vol(bl.at(p[M_L_COMB1]), p[V_COMB1])
               + mul_vol(bl.at(p[M_L_COMB2]), p[V_COMB2])
               + mul_vol(bl.at(p[M_L_COMB3]), p[V_COMB3])
               + mul_vol(bl.at(p[M_L_COMB4]), p[V_COMB4]);
      int ro = mul_vol(br.at(p[M_R_COMB1]), p[V_COMB1])
               + mul_vol(br.at(p[M_R_COMB2]), p[V_COMB2])
               + mul_vol(br.at(p[M_R_COMB3]), p[V_COMB3])
               + mul_vol(br.at(p[M_R_COMB4]), p[V_COMB4]);

      // all-pass 1
      int ap = bl.at(l_apf1);
      lo = lo - mul_vol(ap, p[V_APF1]);
      bl.at(p[M_L_APF1]) = clamp16(lo);
      lo = mul_vol(lo, p[V_APF1]) + ap;

      ap = br.at(r_apf1);
      ro = ro - mul_vol(ap, p[V_APF1]);
      br.at(p[M_R_APF1]) = clamp16(ro);
      ro = mul_vol(ro, p[V_APF1]) + ap;

      // all-pass 2
      ap = bl.at(l_apf2);
      lo = lo - mul_vol(ap, p[V_APF2]);
      bl.at(p[M_L_APF2]) = clamp16(lo);
      lo = mul_vol(lo, p[V_APF2]) + ap;

      ap = br.at(r_apf2);
      ro = ro - mul_vol(ap, p[V_APF2]);
      br.at(p[M_R_APF2]) = clamp16(ro);
      ro = mul_vol(ro, p[V_APF2]) + ap;

      bl.pos = br.pos = (bl.pos + 1) & (kBuffer - 1);
      last_l = clamp16(lo);
      last_r = clamp16(ro);
      accum = __fsub_rn(accum, 1.0f);
    }
    float ol = l, orr = r;
    if (enabled && ticked) {
      // (x * dry + (last / 32767) * wet) * vol, uncontracted
      const float lw = __fdiv_rn((float)last_l, 32767.0f);
      const float rw = __fdiv_rn((float)last_r, 32767.0f);
      ol = __fmul_rn(__fadd_rn(__fmul_rn(l, dry), __fmul_rn(lw, wet)), vol);
      orr = __fmul_rn(__fadd_rn(__fmul_rn(r, dry), __fmul_rn(rw, wet)),
                      vol);
    }
    out_l[row + i] = ol;
    out_r[row + i] = orr;
  }
  pos_io[s] = bl.pos;
  accum_io[s] = accum;
}

// resampler.py _gauss: ((g0*s0 + g1*s1) + g2*s2) + g3*s3, then / 32768.
__device__ __forceinline__ float gauss(float s0, float s1, float s2,
                                       float s3, int idx) {
  const float g0 = (float)kGauss[0xFF - idx];
  const float g1 = (float)kGauss[0x1FF - idx];
  const float g2 = (float)kGauss[0x100 + idx];
  const float g3 = (float)kGauss[idx];
  float acc = __fadd_rn(__fmul_rn(g0, s0), __fmul_rn(g1, s1));
  acc = __fadd_rn(acc, __fmul_rn(g2, s2));
  acc = __fadd_rn(acc, __fmul_rn(g3, s3));
  return __fdiv_rn(acc, 32768.0f);
}

__global__ void __launch_bounds__(64)
spu_resample_kernel(float* __restrict__ hist_l, float* __restrict__ hist_r,
                    int* __restrict__ pc_io, float* __restrict__ acc_l_io,
                    float* __restrict__ acc_r_io, int* __restrict__ cnt_io,
                    const float* __restrict__ left,
                    const float* __restrict__ right,
                    float* __restrict__ out_l, float* __restrict__ out_r,
                    int streams, int n, int pitch, int ratio, int enabled) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= streams) return;
  float hl0 = hist_l[4 * s], hl1 = hist_l[4 * s + 1],
        hl2 = hist_l[4 * s + 2], hl3 = hist_l[4 * s + 3];
  float hr0 = hist_r[4 * s], hr1 = hist_r[4 * s + 1],
        hr2 = hist_r[4 * s + 2], hr3 = hist_r[4 * s + 3];
  int pc = pc_io[s], cnt = cnt_io[s];
  float al = acc_l_io[s], ar = acc_r_io[s];
  const size_t row = (size_t)s * n;
  for (int i = 0; i < n; ++i) {
    const float l = left[row + i], r = right[row + i];
    al = __fadd_rn(al, l);
    ar = __fadd_rn(ar, r);
    cnt += 1;
    if (cnt >= ratio) {
      const float c = (float)cnt;
      hl0 = hl1; hl1 = hl2; hl2 = hl3;
      hl3 = clipf(__fdiv_rn(al, c), -1.5f, 1.5f);
      hr0 = hr1; hr1 = hr2; hr2 = hr3;
      hr3 = clipf(__fdiv_rn(ar, c), -1.5f, 1.5f);
      al = 0.0f;
      ar = 0.0f;
      cnt = 0;
    }
    pc += pitch;
    const int idx = (pc >> 4) & 0xFF;
    const float gl = clipf(gauss(hl0, hl1, hl2, hl3, idx), -1.5f, 1.5f);
    const float gr = clipf(gauss(hr0, hr1, hr2, hr3, idx), -1.5f, 1.5f);
    if (pc >= 0x1000) pc &= 0xFFF;
    out_l[row + i] = enabled ? gl : l;
    out_r[row + i] = enabled ? gr : r;
  }
  hist_l[4 * s] = hl0; hist_l[4 * s + 1] = hl1;
  hist_l[4 * s + 2] = hl2; hist_l[4 * s + 3] = hl3;
  hist_r[4 * s] = hr0; hist_r[4 * s + 1] = hr1;
  hist_r[4 * s + 2] = hr2; hist_r[4 * s + 3] = hr3;
  pc_io[s] = pc;
  cnt_io[s] = cnt;
  acc_l_io[s] = al;
  acc_r_io[s] = ar;
}

constexpr int kThreads = 64;

}  // namespace

// Both entry points update the state arrays in place (the wrappers pass
// copies), write the (streams, n) outputs, launch on `stream` and return
// the launch's CUDA error (0: none).

extern "C" int spu_reverb(int* buf_l, int* buf_r, int* pos, float* accum,
                          const int* params, const float* left,
                          const float* right, float* out_l, float* out_r,
                          int streams, int n, float wet, float dry,
                          float vol, float inc, int enabled, void* stream) {
  if (streams <= 0 || n <= 0) return 0;
  const int blocks = (streams + kThreads - 1) / kThreads;
  spu_reverb_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      buf_l, buf_r, pos, accum, params, left, right, out_l, out_r, streams,
      n, wet, dry, vol, inc, enabled);
  return (int)cudaGetLastError();
}

extern "C" int spu_resample(float* hist_l, float* hist_r, int* pc,
                            float* acc_l, float* acc_r, int* cnt,
                            const float* left, const float* right,
                            float* out_l, float* out_r, int streams, int n,
                            int pitch, int ratio, int enabled,
                            void* stream) {
  if (streams <= 0 || n <= 0) return 0;
  if (ratio <= 0) return (int)cudaErrorInvalidValue;
  const int blocks = (streams + kThreads - 1) / kThreads;
  spu_resample_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      hist_l, hist_r, pc, acc_l, acc_r, cnt, left, right, out_l, out_r,
      streams, n, pitch, ratio, enabled);
  return (int)cudaGetLastError();
}
