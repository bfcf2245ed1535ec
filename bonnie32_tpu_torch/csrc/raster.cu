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
//                      black colour-key test, strict `izi > depth` merge.
//   raster_resolve     phase 2 (_run_phase2): winner attributes, affine UV,
//                      wrap, texel fetch, key fixups, 5->8 expand, vertex-
//                      colour modulate, shade, Bayer dither, RGB555
//                      quantize, RGBA8 pack; background where no face won.
//
// Design.  The TPU kernel walks faces sequentially over VMEM-resident
// planes because its grid runs in order on one core.  Here one thread owns
// one pixel: a 16x16 block walks its instance's compacted faces in draw
// order, staging face records in shared memory a batch at a time and
// skipping, block-uniformly, every face whose bbox misses the tile.  Each
// thread keeps (depth, winner, bcx, bcy) in registers and writes the four
// (I, H, W) planes once, so there are no atomics and the result is
// deterministic.  The resolve kernel is one thread per pixel and reads the
// winner's 32-float attribute row from global memory.
//
// What bounds it on the H100: the visibility kernel is bound by the
// per-pixel face loop (every face whose bbox touches the tile costs each of
// the tile's 256 threads ~20 f32 ops), not by memory: its output is 16 B a
// pixel.  The resolve kernel reads three of those planes and writes the
// colour (16 B a pixel) plus one attribute row and texel per covered
// pixel, mostly L2 hits.  wgmma, TMA, warp-specialised pipelines and fusing the two kernels
// are later work.
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

constexpr int FLAG_DITHER = 1, FLAG_BT = 2;
constexpr int TILE = 16;                 // 16x16 pixels, one thread each
constexpr int THREADS = TILE * TILE;
constexpr int BATCH = 128;               // face records staged per round
constexpr int N_FSCAL = 16;              // attrs columns phase 1 reads
constexpr float COVER_EPS = -0.0001f;

struct FaceCtl {
  int x_lo, x_hi, y_lo, y_hi, tid, keyable, fid, pad;
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
      if (cov && izi > depth) {
        depth = izi;
        winner = c.fid;
        best_bcx = bcx;
        best_bcy = bcy;
      }
    }
  }

  if (xi < width && yi < height) {
    const size_t o = ((size_t)inst * height + yi) * width + xi;
    depth_out[o] = depth;
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
  const int tex8[3] = {expand_5_to_8((c15 >> 10) & 0x1F),
                       expand_5_to_8((c15 >> 5) & 0x1F),
                       expand_5_to_8(c15 & 0x1F)};
  const int vcp[3] = {(int)a[C_VCP0], (int)a[C_VCP0 + 1],
                      (int)a[C_VCP0 + 2]};

  // PS1_DITHER_MATRIX[y & 3][x & 3] in closed form
  const int xe = (xi + (yi & 2)) & 3;
  const int dither = -4 + ((xe & 1) << 2) + (xe >> 1) +
                     ((yi & 1) ? 6 - ((xi & 1) << 3) : 0);

  int word = 255 << 24;
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
      s = a[C_SH + c];
    } else {
      s = interp3(bcx, bcy, bcz, a[C_SH + c], a[C_SH + 3 + c],
                  a[C_SH + 6 + c]);
    }
    const float sc = nan_min(nan_max(s, 0.0f), 2.0f);
    const int shaded = u8_trunc_sat(nan_min((float)mod8 * sc, 255.0f));
    const int q5 = ndith ? min(max((shaded + dither) >> 3, 0), 31)
                         : shaded >> 3;
    word |= expand_5_to_8(q5) << sh8;
  }
  color_out[o] = word;
}

}  // namespace

extern "C" {

int raster_visibility(const int* order, const int* count, const int* ctrl,
                      const float* attrs, const int* tex_data,
                      const int* tex_off, const int* tex_w, const int* tex_h,
                      float* depth, int* winner, float* bcx, float* bcy,
                      int n_inst, int n_faces, int height, int width,
                      void* stream) {
  const dim3 block(TILE, TILE);
  const dim3 grid((width + TILE - 1) / TILE, (height + TILE - 1) / TILE,
                  n_inst);
  visibility_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      order, count, ctrl, attrs, tex_data, tex_off, tex_w, tex_h, depth,
      winner, bcx, bcy, n_faces, height, width);
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

}  // extern "C"
