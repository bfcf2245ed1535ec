// Flat-level rasterizer of the datagen frame, hand-written for Hopper
// (sm_90a).  Built by bonnie32_tpu_torch/ops/_cuda.py with nvcc into a
// shared library with a plain C interface, loaded through ctypes.
//
// What each function replaces (TPU kernel bonnie32_tpu/ops/raster_batch.py,
// `_make_kernel.kernel`, launched by `rasterize_batch` -> pl.pallas_call):
//
//   raster_visibility  phase 1, clean faces (one_face / block / _merge_body /
//                      blk_clean) and keyed faces (blk_keyed / _keyed_body):
//                      faces in compacted draw order, edge functions,
//                      barycentrics, coverage inside the clipped bbox, the
//                      black colour-key test, strict `izi > depth` merge;
//                      with `painters` set, the painter's merge (`better =
//                      cov`, :941) and a cleared depth plane (:1538-1549).
//   raster_resolve     phase 2 (_run_phase2): winner attributes, affine UV,
//                      wrap, texel fetch, key fixups, 5->8 expand, vertex-
//                      colour modulate, shade, Bayer dither, RGB555
//                      quantize, RGBA8 pack; where no face drew, the
//                      background: a constant word, a plane, or the sky.
//   sky_pixel          the in-kernel sky (_sky_chunk_scr, :712-826, and
//                      ops/skybox.py `_sample_sky`): the pixel's view ray
//                      from the camera basis, its spherical angles, the
//                      gradient / tint / haze / sun and moon / cloud
//                      function, clip and truncate to 8 bits, then the
//                      mountain triangles of the per-instance scalar
//                      table, the last covering face winning (a pixel a
//                      mountain covers never evaluates the sphere).  Fused
//                      into raster_resolve (a pixel no face drew), and
//                      alone as raster_sky, the full plane of the
//                      sky-buffer route (ops/skybox.py
//                      `render_skybox_layout`).
//   raster_composite   phase 3 (_run_phase3, :1554-1784): the ordered
//                      composite of a face list onto the colour plane —
//                      z-test against the opaque depth (never written), the
//                      phase-2 pixel pipeline, then the PS1 blend modes and
//                      the editor-alpha lerp, or x-ray's 50% average.
//
// Design.  The TPU kernel walks faces sequentially over VMEM-resident
// planes because its grid runs in order on one core.  Here one thread owns
// one pixel: a 16x16 block walks its instance's compacted faces in draw
// order, staging face records in shared memory a batch at a time and
// skipping, block-uniformly, every face whose bbox misses the tile.  Each
// thread keeps (depth, winner, bcx, bcy) in registers and writes the four
// (I, H, W) planes once, so there are no atomics and the result is
// deterministic.  The resolve kernel is one thread per pixel and reads the
// winner's 32-float attribute row from global memory.  The composite
// kernel has the visibility kernel's shape: a 16x16 block walks its
// instance's composite list in order; warp 0 tests a batch of 32 entries
// against the tile (valid, editor alpha, bbox) and compacts the live ones
// with a ballot, the block stages their records in shared memory, and each
// thread keeps its own colour word in a register, so the ordered blend
// needs no atomics.
//
// What bounds it on the H100: the visibility kernel is bound by the
// per-pixel face loop (every face whose bbox touches the tile costs each of
// the tile's 256 threads ~20 f32 ops), not by memory: its output is 16 B a
// pixel.  The resolve kernel reads three of those planes and writes the
// colour (16 B a pixel) plus one attribute row and texel per covered
// pixel, mostly L2 hits.  The composite kernel reads colour (and depth in
// z-buffer mode) and writes colour, 8-12 B a pixel, only in the tiles that
// a live entry's bbox touches; its work is the full pixel pipeline for
// every pixel of every live entry's bbox in the tile, ~120 integer and f32
// operations each.  The sky writes 4 B a pixel and is bound by its f32
// operations: the ray (two divides, a square root), acos, atan2 where a
// tint or a cloud needs the azimuth, a second acos and a pow per body
// whose glow the ray is inside, six sines and a pow per cloud layer, and
// ~25 operations per mountain face whose box holds the pixel.  The TPU
// gates sun, moon and mountains per chunk of rows.  Here the bodies' gate
// is per pixel (a body beyond four times its size adds exactly nothing,
// so the gate changes no value), and the mountains are staged per block:
// a block of 256 pixels lies in one instance and spans one or two rows,
// its threads load the records of the faces whose box reaches those rows
// into shared memory once, and each pixel then tests only those (a first
// version read every face's box from global memory at every pixel and
// spent three quarters of its time there).  The sky's configuration is a
// kernel argument (SkyParams, by value): a feature that is off costs a
// uniform branch, and a new level costs no recompilation.  wgmma, TMA, warp-specialised
// pipelines and fusing the kernels are later work.
//
// Numerics: every float expression keeps the JAX operation order and the
// build passes -fmad=false, because the TPU never contracts a*b+c into an
// FMA.  Coverage is the three-compare chain (NaN fails it, as jnp.minimum's
// NaN propagation does in the JAX kernel; fminf would drop the NaN).
// The sky's mountains use only + - * / and equal the plain version bit
// for bit; its acosf, atan2f, sinf and powf are CUDA's accurate ones (no
// fast-math), whose last bits differ from torch's, so a sphere pixel may
// sit one 8-bit step from the plain version's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// attrs columns (bonnie32_tpu_torch/ops/raster_batch.py, C_*)
constexpr int N_COLS = 32;
constexpr int C_V3X = 0, C_V3Y = 1, C_A0 = 2, C_B0 = 3, C_A1 = 4, C_B1 = 5;
constexpr int C_IA = 6, C_IZA = 7, C_IZB = 8, C_IZC = 9;
constexpr int C_U0 = 10, C_VV0 = 11, C_U1 = 12, C_VV1 = 13, C_U2 = 14;
constexpr int C_VV2 = 15, C_VCP0 = 16, C_SH = 19, C_TID = 28, C_FLAGS = 29;
// ctrl columns (K_*)
constexpr int N_CTRL = 8;
constexpr int K_XLO = 0, K_XHI = 1, K_YLO = 2, K_YHI = 3, K_TID = 4;
constexpr int K_KEY = 5;

// tctrl columns (T_*), composite tables
constexpr int N_TCTRL = 8, N_TFS = 12;
constexpr int T_FID = 0, T_TID = 1, T_BLEND = 2, T_EA = 3, T_FLAGS = 4;
constexpr int T_VALID = 5;
// BlendMode
constexpr int BM_OPAQUE = 0, BM_AVERAGE = 1, BM_ADD = 2, BM_SUBTRACT = 3;
constexpr int BM_ADD_QUARTER = 4, BM_ERASE = 5;
// composite modes (COMPOSITE_*)
constexpr int MODE_ZBUFFER = 0, MODE_PAINTERS = 1, MODE_XRAY = 2;

constexpr int FLAG_DITHER = 1, FLAG_BT = 2;
constexpr int STP_BIT = 0x8000;
constexpr int TILE = 16;                 // 16x16 pixels, one thread each
constexpr int THREADS = TILE * TILE;
constexpr int BATCH = 128;               // face records staged per round
constexpr int N_FSCAL = 16;              // attrs columns phase 1 reads
constexpr float COVER_EPS = -0.0001f;
constexpr int TBATCH = 32;               // composite entries per round
constexpr int N_TREC = N_FSCAL + N_TFS;  // floats staged per entry
constexpr float INV255 = 1.0f / 255.0f;  // == f32(1/255), the JAX constant

struct FaceCtl {
  int x_lo, x_hi, y_lo, y_hi, tid, keyable, fid, pad;
};

struct TransCtl {
  int x_lo, x_hi, y_lo, y_hi, tid, blend, ea, flags;
};

__device__ __forceinline__ float wrap01(float x) {
  float r = x - truncf(x);
  if (r < 0.0f) r = r + 1.0f;
  return isnan(r) ? 0.0f : r;
}

// Flat atlas index of the texel at (u, v) of texture `tid` >= 0.
__device__ __forceinline__ int texel_index(const int* tex_off,
                                           const int* tex_w,
                                           const int* tex_h, int tid,
                                           float u, float v) {
  const int tw = tex_w[tid];
  const int th = tex_h[tid];
  const int tx = min((int)truncf(wrap01(u) * (float)tw), tw - 1);
  const int ty = min((int)truncf(wrap01(1.0f - v) * (float)th), th - 1);
  return tex_off[tid] + ty * tw + tx;
}

__device__ __forceinline__ float interp3(float bx, float by, float bz,
                                         float a0, float a1, float a2) {
  return (bx * a0 + by * a1) + bz * a2;
}

// Rust `f32 as u8`: truncate, saturate, NaN -> 0.
__device__ __forceinline__ int u8_trunc_sat(float x) {
  if (isnan(x)) return 0;
  return (int)fminf(fmaxf(truncf(x), 0.0f), 255.0f);
}

// jnp.minimum / jnp.maximum against a constant: NaN propagates.
__device__ __forceinline__ float nan_min(float x, float c) {
  return isnan(x) ? x : fminf(x, c);
}
__device__ __forceinline__ float nan_max(float x, float c) {
  return isnan(x) ? x : fmaxf(x, c);
}

__device__ __forceinline__ int expand_5_to_8(int v5) {
  return (v5 << 3) | (v5 >> 2);
}

// PS1_DITHER_MATRIX[y & 3][x & 3] in closed form
__device__ __forceinline__ int dither_offset(int xi, int yi) {
  const int xe = (xi + (yi & 2)) & 3;
  return -4 + ((xe & 1) << 2) + (xe >> 1) +
         ((yi & 1) ? 6 - ((xi & 1) << 3) : 0);
}

// The PS1 pixel pipeline of one textured-or-flat pixel (phase 2's and
// phase 3's shared body): vertex-colour modulate, shade, dither/quantize.
// Writes the three RGB555 channels to q5.
__device__ __forceinline__ void pixel_q5(int c15, const int vcp[3],
                                         const float* sh, int shading,
                                         bool ndith, int dither, float bcx,
                                         float bcy, float bcz, int q5[3]) {
  const int tex8[3] = {expand_5_to_8((c15 >> 10) & 0x1F),
                       expand_5_to_8((c15 >> 5) & 0x1F),
                       expand_5_to_8(c15 & 0x1F)};
  for (int c = 0; c < 3; ++c) {
    const int sh8 = 8 * c;
    const int v8 = u8_trunc_sat(interp3(
        bcx, bcy, bcz, (float)((vcp[0] >> sh8) & 255),
        (float)((vcp[1] >> sh8) & 255), (float)((vcp[2] >> sh8) & 255)));
    const int mod8 = min((tex8[c] * v8) >> 7, 255);
    float s;
    if (shading == 0) {
      s = 1.0f;
    } else if (shading == 1) {
      s = sh[c];
    } else {
      s = interp3(bcx, bcy, bcz, sh[c], sh[3 + c], sh[6 + c]);
    }
    const float sc = nan_min(nan_max(s, 0.0f), 2.0f);
    const int shaded = u8_trunc_sat(nan_min((float)mod8 * sc, 255.0f));
    q5[c] = ndith ? min(max((shaded + dither) >> 3, 0), 31) : shaded >> 3;
  }
}

// blend_rgb555 (render.rs:1093-1145) on 8-bit operands, as v5 << 3
__device__ __forceinline__ int blend5(int blend, int f8, int b8) {
  const int f5 = f8 >> 3, b5 = b8 >> 3;
  int v5;
  switch (blend) {
    case BM_AVERAGE: v5 = min((b5 + f5) >> 1, 31); break;
    case BM_ADD: v5 = min(b5 + f5, 31); break;
    case BM_SUBTRACT: v5 = max(b5 - f5, 0); break;
    case BM_ADD_QUARTER: v5 = min(b5 + (f5 >> 2), 31); break;
    case BM_ERASE: v5 = b5; break;
    default: v5 = f5;
  }
  return v5 << 3;
}

}  // namespace

// The sky's configuration, filled by ops/_cuda.py from
// ops/skybox.py `sky_consts` (same field names) and passed by value.
// Every field is 4 bytes wide.
struct SkyBody {
  int enabled;
  float dx, dy, dz;          // unit direction of the body
  float cos_gate;            // cos(min(4 size, pi)) - 1e-5
  float size, glow_r, glow_span, glow_falloff;
  float color[3], glow_color[3];
};
struct SkyCloud {
  int enabled;
  float vmin, vmax, scroll_speed;
  float f1, p1, s1, f2, p2, s2, f3, p3, s3;
  float threshold, span, height, half_thickness, opacity;
  float color[3];
};
struct SkyParams {
  float zenith[3], horizon_sky[3], horizon_ground[3], nadir[3];
  float horizon, above_div, below_div;
  int has_above, has_below;
  int tint_enabled;
  float tint_dir, tint_spread, tint_intensity, tint_color[3];
  int haze_enabled;
  float haze_extent, haze_intensity, haze_color[3];
  SkyBody body[2];
  SkyCloud cloud[2];
  int need_theta;
  float half_w, half_h, vs, usq;   // view-ray constants
};

namespace {

// rows of the per-instance scalar table (ops/skybox.py, R_*)
constexpr int R_MSX = 0, R_MSY = 1, R_INV = 2, R_BASIS = 3, R_YMIN = 4;
constexpr int R_YMAX = 5, R_XMIN = 6, R_XMAX = 7, SKY_TIME = 9;
constexpr int N_SKY_ROWS = 8, N_FACE_COLS = 12;
constexpr float PI_F = 3.14159265358979323846f;
constexpr float TWO_PI_F = 6.28318530717958647692f;

__device__ __forceinline__ float clipf(float x, float lo, float hi) {
  return nan_min(nan_max(x, lo), hi);
}

// av * (1 - t) + bv * t with the reference's clamp of t, per channel;
// kept only where `sel` (the select after both sides of the JAX code)
__device__ __forceinline__ void lerp3_where(bool sel, float c[3],
                                            const float b[3], float t) {
  t = clipf(t, 0.0f, 1.0f);
  if (!sel) return;
  for (int i = 0; i < 3; ++i) c[i] = c[i] * (1.0f - t) + b[i] * t;
}

// The sphere's word at pixel (xi, yi) of the instance whose scalar table
// is `scal` (N_SKY_ROWS x vpad): the sky function at the pixel's view ray.
__device__ int sky_sphere(const SkyParams& P, const float* __restrict__ scal,
                          int vpad, int xi, int yi) {
  const float* b = scal + R_BASIS * vpad;
  const float ndc_x = (((float)xi + 0.5f) - P.half_w) / P.vs / P.usq;
  const float ndc_y = (((float)yi + 0.5f) - P.half_h) / P.vs / P.usq;
  const float norm = sqrtf((ndc_x * ndc_x + ndc_y * ndc_y) + 1.0f);
  const float cx = ndc_x / norm, cy = ndc_y / norm, cz = 1.0f / norm;
  const float wx = (cx * b[0] + cy * b[3]) + cz * b[6];
  const float wy = (cx * b[1] + cy * b[4]) + cz * b[7];
  const float wz = (cx * b[2] + cy * b[5]) + cz * b[8];
  const float phi = acosf(clipf(wy, -1.0f, 1.0f));
  float theta = 0.0f;
  if (P.need_theta) {
    // jnp.mod(atan2, 2 pi) for an angle in [-pi, pi]
    const float a = atan2f(wz, wx);
    theta = a < 0.0f ? a + TWO_PI_F : a;
  }

  const float v = phi / PI_F;
  const float hz = P.horizon;
  float c[3];
  {
    const bool is_above = v < hz;
    const float t = is_above
        ? (P.has_above ? v / P.above_div : 0.0f)
        : (P.has_below ? (v - hz) / P.below_div : 1.0f);
    const float tc = clipf(t, 0.0f, 1.0f);
    const float* a0 = is_above ? P.zenith : P.horizon_ground;
    const float* a1 = is_above ? P.horizon_sky : P.nadir;
    for (int i = 0; i < 3; ++i) c[i] = a0[i] * (1.0f - tc) + a1[i] * tc;
  }
  if (P.tint_enabled) {
    float diff = fabsf(theta - P.tint_dir);
    if (diff > PI_F) diff = TWO_PI_F - diff;
    const float dt = 1.0f - diff / P.tint_spread;
    const float strength =
        diff < P.tint_spread ? (dt * dt) * P.tint_intensity : 0.0f;
    const float horizon_factor =
        1.0f - nan_min(fabsf(v - hz) / 0.3f, 1.0f);
    lerp3_where(strength > 0.0f, c, P.tint_color, strength * horizon_factor);
  }
  if (P.haze_enabled) {
    const float dist = fabsf(v - hz);
    const float de = 1.0f - dist / P.haze_extent;
    const float s = dist < P.haze_extent ? (de * de) * P.haze_intensity
                                         : 0.0f;
    lerp3_where(s > 0.0f, c, P.haze_color, s);
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const SkyBody& B = P.body[k];
    if (!B.enabled) continue;
    const float cosd = (wx * B.dx + wy * B.dy) + wz * B.dz;
    if (!(cosd > B.cos_gate)) continue;   // beyond the glow: adds nothing
    const float ang = acosf(clipf(cosd, -1.0f, 1.0f));
    const float core = ang < B.size ? 1.0f - ang / B.size : 0.0f;
    const float glow_t = clipf((ang - B.size) / B.glow_span, 0.0f, 1.0f);
    const float glow = (ang >= B.size && ang < B.glow_r)
        ? powf(1.0f - glow_t, B.glow_falloff) * 0.6f : 0.0f;
    lerp3_where(core > 0.0f, c, B.color, core);
    lerp3_where(glow > 0.0f, c, B.glow_color, glow);
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const SkyCloud& L = P.cloud[k];
    if (!L.enabled) continue;
    const bool inside = v >= L.vmin && v <= L.vmax;
    const float th_s = theta + b[SKY_TIME] * L.scroll_speed;
    const float n1 = sinf(sinf(th_s * L.f1 + L.p1) * L.s1 + v * 50.0f);
    const float n2 = sinf(sinf(th_s * L.f2 + L.p2) * L.s2 + v * 120.0f);
    const float n3 = sinf(sinf(th_s * L.f3 + L.p3) * L.s3 + v * 200.0f);
    const float raw =
        clipf(((n1 * 0.5f + n2 * 0.3f) + n3 * 0.2f) + 0.5f, 0.0f, 1.0f);
    const float frac = nan_max((raw - L.threshold) / L.span, 0.0f);
    // the select form: powf's value is dropped where raw < threshold
    const float p = powf(frac, 0.7f);
    const float cval = raw < L.threshold ? 0.0f : p;
    const float dist = fabsf(v - L.height) / L.half_thickness;
    const float edge = clipf(1.0f - dist, 0.0f, 1.0f);
    const float s = inside ? (cval * L.opacity) * edge : 0.0f;
    lerp3_where(s > 0.0f, c, L.color, s);
  }
  // clip, then the saturating convert (NaN -> 0)
  return (255 << 24) | u8_trunc_sat(c[0]) | (u8_trunc_sat(c[1]) << 8) |
         (u8_trunc_sat(c[2]) << 16);
}

// Mountain faces staged per block: x0 y0 x1 y1 x2 y2, 1/dnm, the box
// xmin xmax ymin ymax, then the nine corner colours.
constexpr int SKY_BATCH = 64;
constexpr int N_SKY_REC = 20;
constexpr int SR_INV = 6, SR_XMIN = 7, SR_XMAX = 8, SR_YMIN = 9;
constexpr int SR_YMAX = 10, SR_COL = 11;
struct SkyFaces {
  float rec[SKY_BATCH][N_SKY_REC];
  int live[SKY_BATCH];
};

// The sky word of pixel (xi, yi) for every thread of a 1-D block whose
// pixels lie in one instance (scalar table `scal`) on rows y_first to
// y_last.  EVERY thread of the block calls this (it synchronizes);
// threads with `need` unset get 0 back.  A face is drawn where its box
// holds the pixel centre and the three barycentrics are >= 0; an invalid
// or culled face has an empty box.  The last covering face wins, and
// only a pixel none covers evaluates the sphere.
__device__ int sky_pixel(SkyFaces& sh, const SkyParams& P,
                         const float* __restrict__ scal, int vpad,
                         const int* __restrict__ faces, int n_faces,
                         int y_first, int y_last, bool need, int xi,
                         int yi) {
  const float px = (float)xi + 0.5f, py = (float)yi + 0.5f;
  const float row_lo = (float)y_first + 0.5f;
  const float row_hi = (float)y_last + 0.5f;
  int word = 0;
  bool hit = false;
  for (int base = 0; base < n_faces; base += SKY_BATCH) {
    const int nb = min(SKY_BATCH, n_faces - base);
    __syncthreads();   // the previous batch is no longer read
    for (int f = threadIdx.x; f < nb; f += blockDim.x) {
      const int g = base + f;
      const float ymin = scal[R_YMIN * vpad + g];
      const float ymax = scal[R_YMAX * vpad + g];
      // block-uniform per face: does its box reach this block's rows
      const bool live = ymax >= row_lo && ymin <= row_hi;
      sh.live[f] = live;
      if (!live) continue;
      const int* fc = faces + g * N_FACE_COLS;
      float* r = sh.rec[f];
      for (int k = 0; k < 3; ++k) {
        r[2 * k] = scal[R_MSX * vpad + fc[k]];
        r[2 * k + 1] = scal[R_MSY * vpad + fc[k]];
      }
      r[SR_INV] = scal[R_INV * vpad + g];
      r[SR_XMIN] = scal[R_XMIN * vpad + g];
      r[SR_XMAX] = scal[R_XMAX * vpad + g];
      r[SR_YMIN] = ymin;
      r[SR_YMAX] = ymax;
      for (int k = 0; k < 9; ++k) r[SR_COL + k] = (float)fc[3 + k];
    }
    __syncthreads();
    if (!need) continue;
    for (int f = 0; f < nb; ++f) {
      if (!sh.live[f]) continue;
      const float* r = sh.rec[f];
      if (!(px >= r[SR_XMIN] && px <= r[SR_XMAX] && py >= r[SR_YMIN] &&
            py <= r[SR_YMAX]))
        continue;
      const float x0 = r[0], y0 = r[1], x1 = r[2], y1 = r[3];
      const float x2 = r[4], y2 = r[5];
      const float w0 =
          ((y1 - y2) * (px - x2) + (x2 - x1) * (py - y2)) * r[SR_INV];
      const float w1 =
          ((y2 - y0) * (px - x2) + (x0 - x2) * (py - y2)) * r[SR_INV];
      const float w2 = (1.0f - w0) - w1;
      if (!(w0 >= 0.0f && w1 >= 0.0f && w2 >= 0.0f)) continue;
      hit = true;
      word = 255 << 24;
      for (int ch = 0; ch < 3; ++ch)
        word |= u8_trunc_sat(truncf(
                    (w0 * r[SR_COL + ch] + w1 * r[SR_COL + 3 + ch]) +
                    w2 * r[SR_COL + 6 + ch]))
                << (8 * ch);
    }
  }
  if (need && !hit) word = sky_sphere(P, scal, vpad, xi, yi);
  return word;
}

// What a pixel of resolve shows where no face drew: a plane (I, H, W) or,
// without one, a constant word; or the sky.  The kernel is compiled once
// for each, so that a level without a sky carries none of the sky's
// shared memory or arguments.
struct FlatBackground {
  static constexpr bool IS_SKY = false;
  int word;
  const int* plane;
};
struct SkyBackground {
  static constexpr bool IS_SKY = true;
  const float* skyscal;      // (I, N_SKY_ROWS, vpad)
  const int* sky_faces;      // (n_sky_faces, N_FACE_COLS)
  int n_sky_faces, vpad;
  SkyParams params;
};

template <bool PAINTERS>
__global__ void __launch_bounds__(THREADS)
visibility_kernel(const int* __restrict__ order,
                  const int* __restrict__ count,
                  const int* __restrict__ ctrl,
                  const float* __restrict__ attrs,
                  const int* __restrict__ tex_data,
                  const int* __restrict__ tex_off,
                  const int* __restrict__ tex_w,
                  const int* __restrict__ tex_h,
                  float* __restrict__ depth_out,
                  int* __restrict__ winner_out,
                  float* __restrict__ bcx_out,
                  float* __restrict__ bcy_out,
                  int n_faces, int height, int width) {
  __shared__ float s_f[BATCH][N_FSCAL];
  __shared__ FaceCtl s_c[BATCH];

  const int inst = blockIdx.z;
  const int tile_x0 = blockIdx.x * TILE;
  const int tile_y0 = blockIdx.y * TILE;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int t_lin = ty * TILE + tx;
  const int xi = tile_x0 + tx;
  const int yi = tile_y0 + ty;
  const float px = (float)xi;
  const float py = (float)yi;

  const int n_kept = count[inst];
  const int* order_i = order + (size_t)inst * n_faces;
  const int* ctrl_i = ctrl + (size_t)inst * n_faces * N_CTRL;
  const float* attrs_i = attrs + (size_t)inst * n_faces * N_COLS;

  float depth = 0.0f, best_bcx = 0.0f, best_bcy = 0.0f;
  int winner = -1;

  for (int base = 0; base < n_kept; base += BATCH) {
    const int nb = min(BATCH, n_kept - base);
    __syncthreads();   // the previous batch is no longer read
    for (int j = t_lin; j < nb * N_FSCAL; j += THREADS) {
      const int f = j / N_FSCAL, c = j % N_FSCAL;
      s_f[f][c] = attrs_i[(size_t)order_i[base + f] * N_COLS + c];
    }
    for (int f = t_lin; f < nb; f += THREADS) {
      const int fo = order_i[base + f];
      const int* k = ctrl_i + (size_t)fo * N_CTRL;
      s_c[f] = FaceCtl{k[K_XLO], k[K_XHI], k[K_YLO], k[K_YHI], k[K_TID],
                       k[K_KEY], fo, 0};
    }
    __syncthreads();

    for (int f = 0; f < nb; ++f) {
      const FaceCtl c = s_c[f];
      // block-uniform skip: the face's bbox misses this tile
      if (c.x_hi <= tile_x0 || c.x_lo >= tile_x0 + TILE ||
          c.y_hi <= tile_y0 || c.y_lo >= tile_y0 + TILE)
        continue;
      const float* a = s_f[f];
      const float dx = px - a[C_V3X];
      const float dy = py - a[C_V3Y];
      const float w0 = a[C_A0] * dx + a[C_B0] * dy;
      const float w1 = a[C_A1] * dx + a[C_B1] * dy;
      const float bcx = w0 * a[C_IA];
      const float bcy = w1 * a[C_IA];
      const float bcz = (1.0f - bcx) - bcy;
      bool cov = bcx >= COVER_EPS && bcy >= COVER_EPS && bcz >= COVER_EPS &&
                 xi >= c.x_lo && xi < c.x_hi && yi >= c.y_lo && yi < c.y_hi;
      if (cov && c.keyable) {
        // keyed faces: black texels drop out of coverage before the merge
        const float u = interp3(bcx, bcy, bcz, a[C_U0], a[C_U1], a[C_U2]);
        const float v = interp3(bcx, bcy, bcz, a[C_VV0], a[C_VV1],
                                a[C_VV2]);
        const int texel =
            tex_data[texel_index(tex_off, tex_w, tex_h, c.tid, u, v)];
        cov = (texel & 0x7FFF) != 0;
      }
      const float izi = (bcx * a[C_IZA] + bcy * a[C_IZB]) + bcz * a[C_IZC];
      // painter's: the last covering face wins, whatever its depth
      if (cov && (PAINTERS || izi > depth)) {
        depth = izi;
        winner = c.fid;
        best_bcx = bcx;
        best_bcy = bcy;
      }
    }
  }

  if (xi < width && yi < height) {
    const size_t o = ((size_t)inst * height + yi) * width + xi;
    depth_out[o] = PAINTERS ? 0.0f : depth;   // painter's never writes depth
    winner_out[o] = winner;
    bcx_out[o] = best_bcx;
    bcy_out[o] = best_bcy;
  }
}

// The full sky plane.  Grid: (blocks of 256 pixels of one plane,
// instances).
__global__ void __launch_bounds__(256)
sky_kernel(const float* __restrict__ skyscal,
           const int* __restrict__ sky_faces, int* __restrict__ color_out,
           int n_sky_faces, int vpad, int height, int width,
           const __grid_constant__ SkyParams sky) {
  __shared__ SkyFaces sh;
  const int plane = height * width;
  const int inst = blockIdx.y;
  const int first = blockIdx.x * blockDim.x;
  const int pix = first + threadIdx.x;
  const bool inside = pix < plane;
  const int word = sky_pixel(
      sh, sky, skyscal + (size_t)inst * N_SKY_ROWS * vpad, vpad, sky_faces,
      n_sky_faces, first / width,
      (min(first + (int)blockDim.x, plane) - 1) / width, inside,
      pix % width, pix / width);
  if (inside) color_out[(size_t)inst * plane + pix] = word;
}

// The colour word of the pixel whose winner is face row `a`; false where
// its texel is keyed out and the background shows.
__device__ __forceinline__ bool resolve_pixel(
    const float* __restrict__ a, float bcx, float bcy,
    const int* __restrict__ tex_data, const int* __restrict__ tex_off,
    const int* __restrict__ tex_w, const int* __restrict__ tex_h,
    int shading, int xi, int yi, int& word) {
  const float bcz = (1.0f - bcx) - bcy;
  const float u = interp3(bcx, bcy, bcz, a[C_U0], a[C_U1], a[C_U2]);
  const float v = interp3(bcx, bcy, bcz, a[C_VV0], a[C_VV1], a[C_VV2]);

  const int tid = (int)a[C_TID];
  const bool textured = tid >= 0;
  const int texel = tex_data[texel_index(tex_off, tex_w, tex_h,
                                         max(tid, 0), u, v)];
  const int flags = (int)a[C_FLAGS];
  const bool bt = (flags & FLAG_BT) != 0;
  const bool ndith = (flags & FLAG_DITHER) != 0;

  int c15 = textured ? texel : 0x7FFF;
  const bool is_black = ((c15 >> 10) & 0x1F) == 0 &&
                        ((c15 >> 5) & 0x1F) == 0 && (c15 & 0x1F) == 0;
  if (is_black && bt && textured) return false;   // colour key
  if (c15 == 0 && !bt) c15 = 0x8000;  // drawable black
  const int vcp[3] = {(int)a[C_VCP0], (int)a[C_VCP0 + 1],
                      (int)a[C_VCP0 + 2]};
  int q5[3];
  pixel_q5(c15, vcp, a + C_SH, shading, ndith, dither_offset(xi, yi), bcx,
           bcy, bcz, q5);
  word = (255 << 24) | expand_5_to_8(q5[0]) | (expand_5_to_8(q5[1]) << 8) |
         (expand_5_to_8(q5[2]) << 16);
  return true;
}

// Grid: (blocks of 256 pixels of one plane, instances).
template <typename Bg>
__global__ void __launch_bounds__(256)
resolve_kernel(const int* __restrict__ winner,
               const float* __restrict__ bcx_in,
               const float* __restrict__ bcy_in,
               const float* __restrict__ attrs,
               const int* __restrict__ tex_data,
               const int* __restrict__ tex_off,
               const int* __restrict__ tex_w,
               const int* __restrict__ tex_h,
               int* __restrict__ color_out,
               int n_faces, int height, int width,
               int shading, const __grid_constant__ Bg bg) {
  const int plane = height * width;
  const int inst = blockIdx.y;
  const int first = blockIdx.x * blockDim.x;
  const int pix = first + threadIdx.x;
  const bool inside = pix < plane;
  const size_t o = (size_t)inst * plane + pix;
  const int yi = pix / width;
  const int xi = pix % width;

  int word = 0;
  bool drawn = false;
  if (inside) {
    const int w = winner[o];
    if (w >= 0)
      drawn = resolve_pixel(attrs + ((size_t)inst * n_faces + w) * N_COLS,
                            bcx_in[o], bcy_in[o], tex_data, tex_off, tex_w,
                            tex_h, shading, xi, yi, word);
  }
  const bool need = inside && !drawn;
  if constexpr (Bg::IS_SKY) {   // every thread of the block takes part
    __shared__ SkyFaces sh;
    const int s = sky_pixel(
        sh, bg.params, bg.skyscal + (size_t)inst * N_SKY_ROWS * bg.vpad,
        bg.vpad, bg.sky_faces, bg.n_sky_faces, first / width,
        (min(first + (int)blockDim.x, plane) - 1) / width, need, xi, yi);
    if (need) word = s;
  } else if (need) {
    word = bg.plane != nullptr ? bg.plane[o] : bg.word;
  }
  if (inside) color_out[o] = word;
}

// Phase 3.  ZACTIVE: z-test against the opaque depth (z-buffer mode, not
// x-ray).  XRAY: the 50% average in place of blend modes and editor alpha.
template <bool ZACTIVE, bool XRAY>
__global__ void __launch_bounds__(THREADS)
composite_kernel(const int* __restrict__ tctrl,
                 const float* __restrict__ tfscal,
                 const int* __restrict__ ctrl,
                 const float* __restrict__ attrs,
                 const int* __restrict__ tex_data,
                 const int* __restrict__ tex_off,
                 const int* __restrict__ tex_w,
                 const int* __restrict__ tex_h,
                 const float* __restrict__ depth_in,
                 int* __restrict__ color,
                 int n_tr, int n_faces, int height, int width,
                 int shading) {
  __shared__ float s_f[TBATCH][N_TREC];
  __shared__ TransCtl s_c[TBATCH];
  __shared__ int s_fid[TBATCH];
  __shared__ int s_ent[TBATCH];
  __shared__ int s_live;

  const int inst = blockIdx.z;
  const int tile_x0 = blockIdx.x * TILE;
  const int tile_y0 = blockIdx.y * TILE;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int t_lin = ty * TILE + tx;
  const int xi = tile_x0 + tx;
  const int yi = tile_y0 + ty;
  const float px = (float)xi;
  const float py = (float)yi;
  const bool inside = xi < width && yi < height;
  const size_t o = ((size_t)inst * height + yi) * width + xi;

  const int* tctrl_i = tctrl + (size_t)inst * n_tr * N_TCTRL;
  const float* tfscal_i = tfscal + (size_t)inst * n_tr * N_TFS;
  const int* ctrl_i = ctrl + (size_t)inst * n_faces * N_CTRL;
  const float* attrs_i = attrs + (size_t)inst * n_faces * N_COLS;

  // the planes are read at the first batch with a live entry and the
  // colour written back only then: a tile no entry touches moves no bytes
  bool touched = false;
  int word = 0;
  float zbuf = 0.0f;
  const int dither = dither_offset(xi, yi);

  for (int base = 0; base < n_tr; base += TBATCH) {
    const int nb = min(TBATCH, n_tr - base);
    __syncthreads();   // the previous batch is no longer read
    if (t_lin < 32) {
      // warp 0: which entries can draw into this tile, compacted in order
      bool live = false;
      TransCtl c{};
      int fid = 0;
      if (t_lin < nb) {
        const int* tc = tctrl_i + (size_t)(base + t_lin) * N_TCTRL;
        fid = tc[T_FID];
        const int* k = ctrl_i + (size_t)fid * N_CTRL;
        c = TransCtl{k[K_XLO], k[K_XHI], k[K_YLO], k[K_YHI], tc[T_TID],
                     tc[T_BLEND], tc[T_EA], tc[T_FLAGS]};
        live = tc[T_VALID] != 0 && c.ea != 0 && c.x_hi > tile_x0 &&
               c.x_lo < tile_x0 + TILE && c.y_hi > tile_y0 &&
               c.y_lo < tile_y0 + TILE;
      }
      const unsigned mask = __ballot_sync(0xffffffffu, live);
      if (live) {
        const int pos = __popc(mask & ((1u << t_lin) - 1u));
        s_c[pos] = c;
        s_fid[pos] = fid;
        s_ent[pos] = base + t_lin;
      }
      if (t_lin == 0) s_live = __popc(mask);
    }
    __syncthreads();
    const int n_live = s_live;
    if (n_live == 0) continue;   // block-uniform
    if (!touched) {
      touched = true;
      if (inside) {
        word = color[o];
        if (ZACTIVE) zbuf = depth_in[o];
      }
    }
    for (int j = t_lin; j < n_live * N_TREC; j += THREADS) {
      const int f = j / N_TREC, col = j % N_TREC;
      s_f[f][col] = col < N_FSCAL
          ? attrs_i[(size_t)s_fid[f] * N_COLS + col]
          : tfscal_i[(size_t)s_ent[f] * N_TFS + (col - N_FSCAL)];
    }
    __syncthreads();

    for (int f = 0; f < n_live; ++f) {
      const TransCtl c = s_c[f];
      const float* a = s_f[f];
      const float* fs = a + N_FSCAL;   // vcp x3, shade x9
      const float dx = px - a[C_V3X];
      const float dy = py - a[C_V3Y];
      const float w0 = a[C_A0] * dx + a[C_B0] * dy;
      const float w1 = a[C_A1] * dx + a[C_B1] * dy;
      const float bcx = w0 * a[C_IA];
      const float bcy = w1 * a[C_IA];
      const float bcz = (1.0f - bcx) - bcy;
      const bool cov = bcx >= COVER_EPS && bcy >= COVER_EPS &&
                       bcz >= COVER_EPS && xi >= c.x_lo && xi < c.x_hi &&
                       yi >= c.y_lo && yi < c.y_hi;
      if (!cov) continue;
      if (ZACTIVE) {
        const float izi =
            (bcx * a[C_IZA] + bcy * a[C_IZB]) + bcz * a[C_IZC];
        if (!(izi > zbuf)) continue;
      }
      const float u = interp3(bcx, bcy, bcz, a[C_U0], a[C_U1], a[C_U2]);
      const float v = interp3(bcx, bcy, bcz, a[C_VV0], a[C_VV1], a[C_VV2]);
      const bool textured = c.tid >= 0;
      const int texel = tex_data[texel_index(tex_off, tex_w, tex_h,
                                             max(c.tid, 0), u, v)];
      const bool bt = (c.flags & FLAG_BT) != 0;
      int c15 = textured ? texel : 0x7FFF;
      const bool is_black = ((c15 >> 10) & 0x1F) == 0 &&
                            ((c15 >> 5) & 0x1F) == 0 && (c15 & 0x1F) == 0;
      if (is_black && bt && textured) continue;   // keyed out: not drawn
      if (c15 == 0 && !bt) c15 = 0x8000;          // drawable black
      const int vcp[3] = {(int)fs[0], (int)fs[1], (int)fs[2]};
      int q5[3];
      pixel_q5(c15, vcp, fs + 3, shading, (c.flags & FLAG_DITHER) != 0,
               dither, bcx, bcy, bcz, q5);
      const bool semi = (c15 & STP_BIT) != 0 ||
                        (q5[0] == 0 && q5[1] == 0 && q5[2] == 0);
      int out = 255 << 24;
      for (int ch = 0; ch < 3; ++ch) {
        const int front = expand_5_to_8(q5[ch]);
        const int back = (word >> (8 * ch)) & 255;
        int r;
        if (XRAY) {
          r = (front + back) >> 1;   // operands >= 0: >> 1 is // 2
        } else {
          const int p = (semi && c.blend != BM_OPAQUE)
                            ? blend5(c.blend, front, back) : front;
          // editor-alpha lerp (render.rs:564-628): the // 255 is the
          // f32 multiply trunc(x * f32(1/255)), as in the JAX kernel
          r = c.ea < 255
                  ? (int)truncf((float)(p * c.ea + back * (255 - c.ea)) *
                                INV255)
                  : p;
        }
        out |= r << (8 * ch);
      }
      word = out;
    }
  }
  if (inside && touched) color[o] = word;
}

}  // namespace

extern "C" {

int raster_visibility(const int* order, const int* count, const int* ctrl,
                      const float* attrs, const int* tex_data,
                      const int* tex_off, const int* tex_w, const int* tex_h,
                      float* depth, int* winner, float* bcx, float* bcy,
                      int n_inst, int n_faces, int height, int width,
                      int painters, void* stream) {
  const dim3 block(TILE, TILE);
  const dim3 grid((width + TILE - 1) / TILE, (height + TILE - 1) / TILE,
                  n_inst);
  if (painters) {
    visibility_kernel<true><<<grid, block, 0, (cudaStream_t)stream>>>(
        order, count, ctrl, attrs, tex_data, tex_off, tex_w, tex_h, depth,
        winner, bcx, bcy, n_faces, height, width);
  } else {
    visibility_kernel<false><<<grid, block, 0, (cudaStream_t)stream>>>(
        order, count, ctrl, attrs, tex_data, tex_off, tex_w, tex_h, depth,
        winner, bcx, bcy, n_faces, height, width);
  }
  return (int)cudaGetLastError();
}

// `bg_plane` (I, H, W) or, with `sky` set, `skyscal` + `sky_faces` replace
// the constant `background` word where no face drew; at most one of the
// two is given.
int raster_resolve(const int* winner, const float* bcx, const float* bcy,
                   const float* attrs, const int* tex_data,
                   const int* tex_off, const int* tex_w, const int* tex_h,
                   int* color, const int* bg_plane, const float* skyscal,
                   const int* sky_faces, const SkyParams* sky, int n_inst,
                   int n_faces, int height, int width, int shading,
                   int background, int n_sky_faces, int vpad,
                   void* stream) {
  const int threads = 256;
  const dim3 grid((height * width + threads - 1) / threads, n_inst);
  if (sky != nullptr && bg_plane != nullptr) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (sky != nullptr) {
    resolve_kernel<SkyBackground><<<grid, threads, 0, s>>>(
        winner, bcx, bcy, attrs, tex_data, tex_off, tex_w, tex_h, color,
        n_faces, height, width, shading,
        SkyBackground{skyscal, sky_faces, n_sky_faces, vpad, *sky});
  } else {
    resolve_kernel<FlatBackground><<<grid, threads, 0, s>>>(
        winner, bcx, bcy, attrs, tex_data, tex_off, tex_w, tex_h, color,
        n_faces, height, width, shading,
        FlatBackground{background, bg_plane});
  }
  return (int)cudaGetLastError();
}

int raster_sky(const float* skyscal, const int* sky_faces,
               const SkyParams* sky, int* color, int n_inst, int n_sky_faces,
               int vpad, int height, int width, void* stream) {
  const int threads = 256;
  const dim3 grid((height * width + threads - 1) / threads, n_inst);
  sky_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      skyscal, sky_faces, color, n_sky_faces, vpad, height, width, *sky);
  return (int)cudaGetLastError();
}

int raster_composite(const int* tctrl, const float* tfscal, const int* ctrl,
                     const float* attrs, const int* tex_data,
                     const int* tex_off, const int* tex_w, const int* tex_h,
                     const float* depth, int* color, int n_inst, int n_tr,
                     int n_faces, int height, int width, int shading,
                     int mode, void* stream) {
  const dim3 block(TILE, TILE);
  const dim3 grid((width + TILE - 1) / TILE, (height + TILE - 1) / TILE,
                  n_inst);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case MODE_ZBUFFER:
      composite_kernel<true, false><<<grid, block, 0, s>>>(
          tctrl, tfscal, ctrl, attrs, tex_data, tex_off, tex_w, tex_h, depth,
          color, n_tr, n_faces, height, width, shading);
      break;
    case MODE_PAINTERS:
      composite_kernel<false, false><<<grid, block, 0, s>>>(
          tctrl, tfscal, ctrl, attrs, tex_data, tex_off, tex_w, tex_h, depth,
          color, n_tr, n_faces, height, width, shading);
      break;
    case MODE_XRAY:
      composite_kernel<false, true><<<grid, block, 0, s>>>(
          tctrl, tfscal, ctrl, attrs, tex_data, tex_off, tex_w, tex_h, depth,
          color, n_tr, n_faces, height, width, shading);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
