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
//                      quantize, RGBA8 pack; background where no face won.
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
// operations each.  wgmma, TMA, warp-specialised
// pipelines and fusing the kernels are later work.
//
// Numerics: every float expression keeps the JAX operation order and the
// build passes -fmad=false, because the TPU never contracts a*b+c into an
// FMA.  Coverage is the three-compare chain (NaN fails it, as jnp.minimum's
// NaN propagation does in the JAX kernel; fminf would drop the NaN).

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
               long long n_pixels, int n_faces, int height, int width,
               int shading, int background) {
  const long long o = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= n_pixels) return;
  const int w = winner[o];
  if (w < 0) {
    color_out[o] = background;
    return;
  }
  const long long plane = (long long)height * width;
  const long long inst = o / plane;
  const int pix = (int)(o % plane);
  const int yi = pix / width;
  const int xi = pix % width;
  const float* a = attrs + ((size_t)inst * n_faces + w) * N_COLS;

  const float bcx = bcx_in[o];
  const float bcy = bcy_in[o];
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
  if (is_black && bt && textured) {   // colour key: background shows
    color_out[o] = background;
    return;
  }
  if (c15 == 0 && !bt) c15 = 0x8000;  // drawable black
  const int vcp[3] = {(int)a[C_VCP0], (int)a[C_VCP0 + 1],
                      (int)a[C_VCP0 + 2]};
  int q5[3];
  pixel_q5(c15, vcp, a + C_SH, shading, ndith, dither_offset(xi, yi), bcx,
           bcy, bcz, q5);
  color_out[o] = (255 << 24) | expand_5_to_8(q5[0]) |
                 (expand_5_to_8(q5[1]) << 8) | (expand_5_to_8(q5[2]) << 16);
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

int raster_resolve(const int* winner, const float* bcx, const float* bcy,
                   const float* attrs, const int* tex_data,
                   const int* tex_off, const int* tex_w, const int* tex_h,
                   int* color, int n_inst, int n_faces, int height,
                   int width, int shading, int background, void* stream) {
  const long long n_pixels = (long long)n_inst * height * width;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n_pixels + threads - 1) / threads);
  resolve_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      winner, bcx, bcy, attrs, tex_data, tex_off, tex_w, tex_h, color,
      n_pixels, n_faces, height, width, shading, background);
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
