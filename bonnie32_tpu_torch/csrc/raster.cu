// Flat-level rasterizer of the datagen frame, hand-written for Hopper
// (sm_90a).  Built by bonnie32_tpu_torch/ops/_cuda.py with nvcc into a
// shared library with a plain C interface, loaded through ctypes.
//
// What each function replaces (TPU kernel bonnie32_tpu/ops/raster_batch.py,
// `_make_kernel.kernel`, launched by `rasterize_batch` -> pl.pallas_call):
//
//   raster_bin         the clipping of each face's bbox to the row blocks it
//                      reaches (one_face / block, :859-878: yb0, nblk, K_G0,
//                      K_NG), which lets the TPU kernel walk a face over its
//                      own blocks only: here, once per launch, a bit mask
//                      per tile of the list entries whose bbox touches it.
//   raster_visibility  phase 1, clean faces (one_face / block / _merge_body /
//                      blk_clean) and keyed faces (blk_keyed / _keyed_body):
//                      faces in compacted draw order, edge functions,
//                      barycentrics, coverage inside the clipped bbox, the
//                      black colour-key test, strict `izi > depth` merge;
//                      with `painters` set, the painter's merge (`better =
//                      cov`, :941) and a cleared depth plane (:1538-1549).
//   raster_resolve     phase 2 (_run_phase2): winner attributes, affine or
//                      perspective-correct UV, wrap, texel fetch, key
//                      fixups, 5->8 expand, vertex-
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
// planes because its grid runs in order on one core, and each face only
// over the blocks of its own bbox.  Here one block owns one 16x16 tile of
// one instance's frame, and a tile pays only for the faces that touch it:
//
//   * raster_bin runs first, one block an instance.  A warp owns 32
//     consecutive entries of the ordered list (the kept faces through
//     `order`, or the composite list): each lane reads its entry's clipped
//     bbox ONCE and turns it into a range of tile columns and rows, and the
//     warp then walks the tiles with one ballot each.  Out comes, per tile,
//     ceil(L / 32) mask words whose bit order is draw order (so no consumer
//     sorts, and the result is deterministic), and for the composite the
//     list of (instance, tile) pairs with any bit, appended with one atomic
//     add a block.  At N=1024, 320x240, L=328 the masks are 13.5 MB and
//     stay in the 50 MB L2 until the consumer reads them.
//   * The visibility kernel's block reads its tile's words (warp 0, one
//     coalesced read), expands the set bits in order into list positions
//     (prefix sum over the popcounts, __ffs), stages those faces' records
//     in shared memory with 16-byte loads (16 attrs floats and the ctrl row
//     through order[p]) and walks them.  A thread owns four rows of one
//     column: it keeps (depth, winner, bcx, bcy) of its pixels in registers
//     and writes the four (I, H, W) planes once, so there are no atomics; a
//     tile is 64 threads, so 32 tiles are in flight on an SM, which hides
//     the three dependent reads (words -> order -> rows) a tile starts with.
//   * The composite kernel is a fixed grid (as many blocks as fit the card)
//     that draws tiles from the work list through a cursor in device
//     memory, so a tile no live entry touches costs nothing and blocks
//     stay balanced though tiles differ in work by an order of magnitude.
//     It stages per entry what the pixel pipeline would otherwise redo at
//     every pixel (vertex colours unpacked to floats, the texture's offset
//     and size), keeps each pixel's colour word in a register through the
//     ordered blend, and writes it back only where an entry drew.
//   * The resolve kernel is one thread per pixel and reads the winner's
//     32-float attribute row from global memory.
//
// What bounds them on the H100 (numbers: PERF.md).  With every face of the
// level staged and tested in every tile (the first port) the visibility
// kernel spent 83% of its time on faces that do not touch the tile.  Binned,
// a 16x16 tile holds 3.3 faces on average and the kernel is within a factor
// of two of the 16 B a pixel it writes; what is left is the latency of the
// dependent reads at the start of each tile, and the 45% of the tiles that
// are empty still wait for their words before they may store.  Tile shapes
// whose rows fill 128-byte lines (32x8) measured slower than 16x16: more
// faces per tile, no gain from the wider stores.  The composite kernels are
// bound by the length of the pixel pipeline, ~250 machine operations a
// covered pixel and entry, most of them integer and conversion work that
// the f32 bound does not see: x-ray, where every face of the level goes through it, is the
// slowest launch of the file.  The resolve kernel reads three planes and
// writes the colour (16 B a pixel) plus one attribute row and texel per
// covered pixel, mostly L2 hits.
//
// The sky writes 4 B a pixel.  Both its entry points give a block one
// 32x16 tile of one instance's frame, a thread two rows of one column.
// The block fills its tables once: ndc_x of its columns, ndc_y of its
// rows (the plain version's expressions, so the values are the same) and
// the camera basis.  Each thread then tests one mountain face's box
// against the tile's pixel centres; a ballot and a prefix over the warps'
// counts compact the survivors, in draw order, into shared memory, and a
// tile that none survives (two thirds of them) stages nothing.  A pixel
// walks only its tile's faces, well under one on average.  The fused
// route skips the sky, tables and faces included, in a tile whose every
// pixel a face drew.  Work that a select drops is not done: the azimuth
// where neither the tint nor a cloud reads it, the tint and the haze
// outside their ranges, a cloud layer's sines outside its band and its
// pow below the threshold.
//
// What bounds the sky now is its instruction stream.  With only the
// gradient on, a pixel runs about 270 machine instructions at close to
// the SMs' issue rate: the view ray's square root and three divides, acos,
// the divides by pi and of the gradient, every IEEE divide about ten
// instructions with its slow-path check, and the NaN-keeping clamps.  The
// rest is latency: each tile's box reads and barriers, which the blocks
// resident on an SM hide only in part (PERF.md).  The sky's
// configuration is a kernel argument (SkyParams, by value): a feature that
// is off costs a uniform branch, and a new level costs no recompilation.
// wgmma, TMA, warp-specialised pipelines and fusing the kernels are later
// work.
//
// Perspective-correct UVs (affine_textures off, render.rs:1563-1579) are a
// template parameter of the visibility (keyed coverage, :1003-1013), resolve
// (:1249-1262) and composite kernels, as the painter's merge, the z-test and
// the background kind are, so the affine instantiations carry none of it:
// u/z and v/z interpolated over the corners' 1/z, divided by the pixel's
// interpolated 1/z (1 where that is 0), an IEEE divide each.  The 1/z is the
// face's own at the pixel; for resolve, the winner's, recomputed from the
// winner's barycentrics and attribute row, which is bit for bit the value
// phase 1 merged into the depth plane (the same expression on the same
// inputs), so the painter's merge, whose depth plane comes back cleared,
// needs no hand-off.
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
// a ctrl row (K_*), read as two int4: x_lo, x_hi, y_lo, y_hi (the clipped
// half-open bbox), then tid, keyable and two unused columns
constexpr int N_CTRL = 8;

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
// The tile of the frame that one block owns (ops/_cuda.py builds with the
// TILE_H / TILE_W of ops/raster_batch.py, which the plain binning uses), and
// the rows of one column that one thread owns in it: four for the
// visibility kernel (64 threads a tile, so many tiles are in flight on an
// SM), two for the composite.  scripts/torch_tile_sweep.py builds other
// shapes to measure them.
#ifndef RASTER_TILE_W
#define RASTER_TILE_W 16
#endif
#ifndef RASTER_TILE_H
#define RASTER_TILE_H 16
#endif
#ifndef RASTER_VIS_ROWS
#define RASTER_VIS_ROWS 4
#endif
#ifndef RASTER_COMP_ROWS
#define RASTER_COMP_ROWS 2
#endif
constexpr int TILE_W = RASTER_TILE_W, TILE_H = RASTER_TILE_H;
constexpr int VIS_ROWS = RASTER_VIS_ROWS, COMP_ROWS = RASTER_COMP_ROWS;
constexpr int VIS_THREADS = TILE_W * (TILE_H / VIS_ROWS);
// registers capped so that 1280 threads fit an SM (48 a thread): left to
// itself the compiler takes 64 for the z-buffer merge, 16 tiles an SM, and
// the kernel is 6% slower; capped at 40 it spills and is 20% slower
constexpr int VIS_MIN_BLOCKS = 1280 / VIS_THREADS;
// The perspective instantiations divide in the keyed-coverage test.  An
// IEEE divide's slow path is a call, across which the merge's live values
// spill under the 48-register cap (112 bytes a thread; the z-buffer kernel
// took 1.02 ms against the affine one's 0.75); capped at 64 registers
// (1024 threads an SM) they do not spill and take 0.85 ms, at 80 (768)
// 0.97 (PERF.md; scripts/torch_tile_sweep.py measures other caps).
#ifndef RASTER_VIS_PERSP_THREADS
#define RASTER_VIS_PERSP_THREADS 1024
#endif
constexpr int VIS_MIN_BLOCKS_PERSP = RASTER_VIS_PERSP_THREADS / VIS_THREADS;
constexpr int COMP_THREADS = TILE_W * (TILE_H / COMP_ROWS);
static_assert(TILE_H % VIS_ROWS == 0 && VIS_THREADS % 32 == 0 &&
                  VIS_THREADS <= 1024 && TILE_H % COMP_ROWS == 0 &&
                  COMP_THREADS % 32 == 0 && COMP_THREADS <= 1024,
              "a block is whole warps, each thread a column of ROWS pixels");
constexpr int BATCH = 64;                // records staged per round, >= 32
constexpr int N_FSCAL = 16;              // attrs columns phase 1 reads
constexpr int N_REC4 = 8;                // 16-byte loads staged per record
constexpr int BIN_THREADS = 256;         // raster_bin: 8 warps an instance
constexpr int BIN_CHUNK = 1024;          // tiles binned per round
constexpr unsigned FULL = 0xffffffffu;
constexpr float COVER_EPS = -0.0001f;
constexpr int N_TREC = N_FSCAL + N_TFS;  // floats staged per entry
constexpr float INV255 = 1.0f / 255.0f;  // == f32(1/255), the JAX constant

__device__ __forceinline__ float wrap01(float x) {
  float r = x - truncf(x);
  if (r < 0.0f) r = r + 1.0f;
  return isnan(r) ? 0.0f : r;
}

// Flat atlas index of the texel at (u, v) of texture `tid` >= 0.
__device__ __forceinline__ int texel_at(int off, int tw, int th, float u,
                                        float v) {
  const int tx = min((int)truncf(wrap01(u) * (float)tw), tw - 1);
  const int ty = min((int)truncf(wrap01(1.0f - v) * (float)th), th - 1);
  return off + ty * tw + tx;
}
__device__ __forceinline__ int texel_index(const int* tex_off,
                                           const int* tex_w,
                                           const int* tex_h, int tid,
                                           float u, float v) {
  return texel_at(tex_off[tid], tex_w[tid], tex_h[tid], u, v);
}

__device__ __forceinline__ float interp3(float bx, float by, float bz,
                                         float a0, float a1, float a2) {
  return (bx * a0 + by * a1) + bz * a2;
}

// Perspective-correct texture coordinate (render.rs:1563-1579): the
// corners' t/z interpolated, over the pixel's interpolated 1/z `izi` (1
// where that is 0); `iz0..2` are the corners' 1/z.  The divide is IEEE
// round-to-nearest (no fast-math), as the reference's exact division.
__device__ __forceinline__ float persp3(float bx, float by, float bz,
                                        float t0, float t1, float t2,
                                        float iz0, float iz1, float iz2,
                                        float izi) {
  const float safe = izi == 0.0f ? 1.0f : izi;
  return (((bx * t0) * iz0 + (by * t1) * iz1) + (bz * t2) * iz2) / safe;
}

// Rust `f32 as u8`: truncate, saturate, NaN -> 0.
__device__ __forceinline__ int u8_trunc_sat(float x) {
  // cvt.rzi.s32.f32 truncates, saturates and turns NaN into 0
  return min(max(__float2int_rz(x), 0), 255);
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
// `vc`: the three corners' vertex colours, corner-major (r, g, b) x3, as
// floats.  Writes the three RGB555 channels to q5.
__device__ __forceinline__ void pixel_q5(int c15, const float* vc,
                                         const float* sh, int shading,
                                         bool ndith, int dither, float bcx,
                                         float bcy, float bcz, int q5[3]) {
  const int tex8[3] = {expand_5_to_8((c15 >> 10) & 0x1F),
                       expand_5_to_8((c15 >> 5) & 0x1F),
                       expand_5_to_8(c15 & 0x1F)};
  for (int c = 0; c < 3; ++c) {
    const int v8 =
        u8_trunc_sat(interp3(bcx, bcy, bcz, vc[c], vc[3 + c], vc[6 + c]));
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

// The packed vertex colours of three corners as nine floats, corner-major.
__device__ __forceinline__ void unpack_vc(const int vcp[3], float* vc) {
  for (int k = 0; k < 3; ++k)
    for (int c = 0; c < 3; ++c)
      vc[3 * k + c] = (float)((vcp[k] >> (8 * c)) & 255);
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
  float half_w, half_h, vs, usq;   // view-ray constants
};

namespace {

// rows of the per-instance scalar table (ops/skybox.py, R_*)
constexpr int R_MSX = 0, R_MSY = 1, R_INV = 2, R_BASIS = 3, R_YMIN = 4;
constexpr int R_YMAX = 5, R_XMIN = 6, R_XMAX = 7, SKY_TIME = 9;
constexpr int N_SKY_ROWS = 8, N_FACE_COLS = 12;
constexpr float PI_F = 3.14159265358979323846f;
constexpr float TWO_PI_F = 6.28318530717958647692f;

// The tile of one instance's frame that one block of the sky's two entry
// points owns (ops/_cuda.py builds with the SKY_TILE_H / SKY_TILE_W of
// ops/skybox.py, which the plain culling uses), and the rows of one column
// that one thread owns in it.
#ifndef RASTER_SKY_TILE_W
#define RASTER_SKY_TILE_W 32
#endif
#ifndef RASTER_SKY_TILE_H
#define RASTER_SKY_TILE_H 16
#endif
constexpr int SKY_TILE_W = RASTER_SKY_TILE_W, SKY_TILE_H = RASTER_SKY_TILE_H;
constexpr int SKY_THREAD_ROWS = 2;
constexpr int SKY_THREADS = SKY_TILE_W * (SKY_TILE_H / SKY_THREAD_ROWS);
constexpr int SKY_WARPS = SKY_THREADS / 32;
static_assert(SKY_TILE_H % SKY_THREAD_ROWS == 0 && SKY_THREADS % 32 == 0 &&
                  SKY_THREADS <= 1024,
              "a sky tile is whole warps, each thread a column of rows");
// registers capped so that 2048 threads fit an SM (32 a thread, a few
// dozen bytes spilled): left to itself the compiler takes 48, 5 tiles an
// SM, and both entry points ran 1-15% slower
constexpr int SKY_MIN_BLOCKS = 2048 / SKY_THREADS;
// A staged mountain face, five float4: its box (xmin, xmax, ymin, ymax);
// the edge terms (y1 - y2, x2 - x1, y2 - y0, x0 - x2); x2, y2, 1/dnm;
// the nine corner colours, corner-major, from float 11 on.
constexpr int N_SKY_REC4 = 5;

struct SkyTile {
  // every face of a round of SKY_THREADS that survives the tile's cull
  float4 rec[SKY_THREADS][N_SKY_REC4];
  float ndc_x[SKY_TILE_W], ndc_y[SKY_TILE_H];   // the view ray's terms
  float basis[10];                              // row-major, then time
  int warp_count[2][SKY_WARPS];                 // survivors, per round
};

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

// The sphere's word at pixel (tx, ty) of the tile: the sky function at
// the pixel's view ray.  The ray's column and row terms and the camera
// basis come from the tile's tables.  Work whose result a select drops
// is not done, which changes no value: the azimuth (atan2) only where the
// tint or a cloud layer reads it; the tint only where its horizon factor
// is not exactly 0 (|v - hz| / 0.3 >= 1 makes its weight 0, and the lerp
// by 0 returns the colour) and within its spread; the haze within its
// extent; a body's angle within its glow; a cloud layer's noise only
// inside its band, and its pow only where the noise reaches the
// threshold (elsewhere its weight is 0).
__device__ int sky_sphere(const SkyParams& P, const SkyTile& sh, int tx,
                          int ty) {
  const float* b = sh.basis;
  const float ndc_x = sh.ndc_x[tx], ndc_y = sh.ndc_y[ty];
  const float norm = sqrtf((ndc_x * ndc_x + ndc_y * ndc_y) + 1.0f);
  const float cx = ndc_x / norm, cy = ndc_y / norm, cz = 1.0f / norm;
  const float wx = (cx * b[0] + cy * b[3]) + cz * b[6];
  const float wy = (cx * b[1] + cy * b[4]) + cz * b[7];
  const float wz = (cx * b[2] + cy * b[5]) + cz * b[8];
  const float phi = acosf(clipf(wy, -1.0f, 1.0f));
  float theta = 0.0f;
  bool have_theta = false;
  auto azimuth = [&]() {
    if (!have_theta) {
      // jnp.mod(atan2, 2 pi) for an angle in [-pi, pi]
      const float a = atan2f(wz, wx);
      theta = a < 0.0f ? a + TWO_PI_F : a;
      have_theta = true;
    }
    return theta;
  };

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
    const float q = fabsf(v - hz) / 0.3f;
    if (!(q >= 1.0f)) {
      float diff = fabsf(azimuth() - P.tint_dir);
      if (diff > PI_F) diff = TWO_PI_F - diff;
      if (diff < P.tint_spread) {
        const float dt = 1.0f - diff / P.tint_spread;
        const float strength = (dt * dt) * P.tint_intensity;
        const float horizon_factor = 1.0f - nan_min(q, 1.0f);
        lerp3_where(strength > 0.0f, c, P.tint_color,
                    strength * horizon_factor);
      }
    }
  }
  if (P.haze_enabled) {
    const float dist = fabsf(v - hz);
    if (dist < P.haze_extent) {
      const float de = 1.0f - dist / P.haze_extent;
      const float s = (de * de) * P.haze_intensity;
      lerp3_where(s > 0.0f, c, P.haze_color, s);
    }
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const SkyBody& B = P.body[k];
    if (!B.enabled) continue;
    const float cosd = (wx * B.dx + wy * B.dy) + wz * B.dz;
    if (!(cosd > B.cos_gate)) continue;   // beyond the glow: adds nothing
    const float ang = acosf(clipf(cosd, -1.0f, 1.0f));
    const float core = ang < B.size ? 1.0f - ang / B.size : 0.0f;
    float glow = 0.0f;
    if (ang >= B.size && ang < B.glow_r) {
      const float glow_t = clipf((ang - B.size) / B.glow_span, 0.0f, 1.0f);
      glow = powf(1.0f - glow_t, B.glow_falloff) * 0.6f;
    }
    lerp3_where(core > 0.0f, c, B.color, core);
    lerp3_where(glow > 0.0f, c, B.glow_color, glow);
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const SkyCloud& L = P.cloud[k];
    if (!L.enabled) continue;
    if (!(v >= L.vmin && v <= L.vmax)) continue;   // outside: weight 0
    const float th_s = azimuth() + b[SKY_TIME] * L.scroll_speed;
    const float n1 = sinf(sinf(th_s * L.f1 + L.p1) * L.s1 + v * 50.0f);
    const float n2 = sinf(sinf(th_s * L.f2 + L.p2) * L.s2 + v * 120.0f);
    const float n3 = sinf(sinf(th_s * L.f3 + L.p3) * L.s3 + v * 200.0f);
    const float raw =
        clipf(((n1 * 0.5f + n2 * 0.3f) + n3 * 0.2f) + 0.5f, 0.0f, 1.0f);
    if (raw < L.threshold) continue;   // the select drops pow: weight 0
    const float frac = nan_max((raw - L.threshold) / L.span, 0.0f);
    const float cval = powf(frac, 0.7f);
    const float dist = fabsf(v - L.height) / L.half_thickness;
    const float edge = clipf(1.0f - dist, 0.0f, 1.0f);
    const float s = (cval * L.opacity) * edge;
    lerp3_where(s > 0.0f, c, L.color, s);
  }
  // clip, then the saturating convert (NaN -> 0)
  return (255 << 24) | u8_trunc_sat(c[0]) | (u8_trunc_sat(c[1]) << 8) |
         (u8_trunc_sat(c[2]) << 16);
}

// The sky words of the SKY_THREAD_ROWS pixels (xi, y_first + k) of this
// block's tile of instance blockIdx.z, whose scalar table is `scal`, into
// `word` where `need[k]` is set.  EVERY thread of the block calls this (it
// synchronizes).
//
// The tile's tables first: ndc_x of each column and ndc_y of each row
// (the expressions of the plain version, once per tile instead of once a
// pixel), and the camera basis and time.  Then the mountain faces, in
// rounds of SKY_THREADS: each thread tests one face's box against the
// pixel centres of the tile, a ballot and a prefix over the warps' counts
// give each survivor its place in draw order, and the survivors alone are
// staged; a round no face survives stages nothing.  With `words` given,
// lane 0 of each warp stores its ballot there: bit b of word w is face
// 32 w + b (the per-tile lists of ops/skybox.py `sky_tile_faces_ref`).
// A face is drawn where its box holds the pixel centre and the three
// barycentrics are >= 0; an invalid or culled face has an empty box.  The
// last covering face wins, and only a pixel none covers evaluates the
// sphere.
__device__ void sky_tile(SkyTile& sh, const SkyParams& P,
                         const float* __restrict__ scal, int vpad,
                         const int* __restrict__ faces, int n_faces,
                         int* __restrict__ words, int height, int width,
                         const bool need[SKY_THREAD_ROWS], int xi, int y_first,
                         int word[SKY_THREAD_ROWS]) {
  const int tx = threadIdx.x, row0 = threadIdx.y * SKY_THREAD_ROWS;
  const int t = threadIdx.y * SKY_TILE_W + tx;
  const int lane = t & 31, warp = t >> 5;
  const int x0 = blockIdx.x * SKY_TILE_W, y0 = blockIdx.y * SKY_TILE_H;
  for (int i = t; i < SKY_TILE_W + SKY_TILE_H + 10; i += SKY_THREADS) {
    if (i < SKY_TILE_W) {
      sh.ndc_x[i] = (((float)(x0 + i) + 0.5f) - P.half_w) / P.vs / P.usq;
    } else if (i < SKY_TILE_W + SKY_TILE_H) {
      const int r = i - SKY_TILE_W;
      sh.ndc_y[r] = (((float)(y0 + r) + 0.5f) - P.half_h) / P.vs / P.usq;
    } else {
      const int j = i - SKY_TILE_W - SKY_TILE_H;
      sh.basis[j] = scal[R_BASIS * vpad + j];
    }
  }
  // the pixel centres of the tile's part of the frame
  const float lo_x = (float)x0 + 0.5f, lo_y = (float)y0 + 0.5f;
  const float hi_x = (float)(min(x0 + SKY_TILE_W, width) - 1) + 0.5f;
  const float hi_y = (float)(min(y0 + SKY_TILE_H, height) - 1) + 0.5f;
  const float px = (float)xi + 0.5f;
  const int n_words = (n_faces + 31) / 32;

  bool hit[SKY_THREAD_ROWS], any_need = false;
#pragma unroll
  for (int k = 0; k < SKY_THREAD_ROWS; ++k) {
    word[k] = 0;
    hit[k] = false;
    any_need |= need[k];
  }
  for (int base = 0, rnd = 0; base < n_faces; base += SKY_THREADS, ++rnd) {
    const int g = base + t;
    bool live = false;
    float xmin = 0.0f, xmax = 0.0f, ymin = 0.0f, ymax = 0.0f;
    if (g < n_faces) {
      xmin = scal[R_XMIN * vpad + g];
      xmax = scal[R_XMAX * vpad + g];
      ymin = scal[R_YMIN * vpad + g];
      ymax = scal[R_YMAX * vpad + g];
      live = xmax >= lo_x && xmin <= hi_x && ymax >= lo_y && ymin <= hi_y;
    }
    const unsigned m = __ballot_sync(FULL, live);
    if (lane == 0) {
      sh.warp_count[rnd & 1][warp] = __popc(m);
      if (words != nullptr && base / 32 + warp < n_words)
        words[base / 32 + warp] = (int)m;
    }
    __syncthreads();   // counts (and, in round 0, the tables) are written
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < SKY_WARPS; ++w) {
      const int cnt = sh.warp_count[rnd & 1][w];
      before += w < warp ? cnt : 0;
      total += cnt;
    }
    if (total == 0) continue;   // block-uniform: nothing to stage
    if (live) {
      const int* fc = faces + g * N_FACE_COLS;
      const float fx0 = scal[R_MSX * vpad + fc[0]];
      const float fy0 = scal[R_MSY * vpad + fc[0]];
      const float fx1 = scal[R_MSX * vpad + fc[1]];
      const float fy1 = scal[R_MSY * vpad + fc[1]];
      const float fx2 = scal[R_MSX * vpad + fc[2]];
      const float fy2 = scal[R_MSY * vpad + fc[2]];
      float4* r = sh.rec[before + __popc(m & ((1u << lane) - 1u))];
      r[0] = make_float4(xmin, xmax, ymin, ymax);
      r[1] = make_float4(fy1 - fy2, fx2 - fx1, fy2 - fy0, fx0 - fx2);
      r[2] = make_float4(fx2, fy2, scal[R_INV * vpad + g], (float)fc[3]);
      r[3] = make_float4((float)fc[4], (float)fc[5], (float)fc[6],
                         (float)fc[7]);
      r[4] = make_float4((float)fc[8], (float)fc[9], (float)fc[10],
                         (float)fc[11]);
    }
    __syncthreads();   // the survivors are staged
    if (!any_need) continue;
    for (int f = 0; f < total; ++f) {
      const float4 box = sh.rec[f][0];
      if (!(px >= box.x && px <= box.y)) continue;
      const float4 e = sh.rec[f][1];
      const float4 q = sh.rec[f][2];
      const float* col = reinterpret_cast<const float*>(sh.rec[f]) + 11;
      const float dx = px - q.x;
#pragma unroll
      for (int k = 0; k < SKY_THREAD_ROWS; ++k) {
        const float py = (float)(y_first + k) + 0.5f;
        if (!need[k] || !(py >= box.z && py <= box.w)) continue;
        const float dy = py - q.y;
        const float w0 = (e.x * dx + e.y * dy) * q.z;
        const float w1 = (e.z * dx + e.w * dy) * q.z;
        const float w2 = (1.0f - w0) - w1;
        if (!(w0 >= 0.0f && w1 >= 0.0f && w2 >= 0.0f)) continue;
        hit[k] = true;
        int wd = 255 << 24;
        for (int ch = 0; ch < 3; ++ch)
          wd |= u8_trunc_sat(truncf((w0 * col[ch] + w1 * col[3 + ch]) +
                                    w2 * col[6 + ch]))
                << (8 * ch);
        word[k] = wd;
      }
    }
    // the next round writes the other count buffer, and its staging
    // follows its own barrier, which every thread reaches only after its
    // walk here
  }
  if (n_faces == 0) __syncthreads();   // the tables are written
#pragma unroll
  for (int k = 0; k < SKY_THREAD_ROWS; ++k)
    if (need[k] && !hit[k]) word[k] = sky_sphere(P, sh, tx, row0 + k);
}

// ---- binning: which entries of an ordered list touch which tile ----
//
// One block an instance.  A warp owns one 32-entry word of the list at a
// time: each lane reads its entry's clipped bbox once (through `order`, or
// through the composite table's face id) and turns it into the range of
// tile columns and rows it reaches; the warp then walks the tiles, one
// ballot a tile, so the overlap of an entry with a tile is tested once, by
// one thread, and bit b of word w is list position 32 w + b: draw order.
// A lane keeps the ballot of every 32nd tile and the warp stores 32 words
// at a time.  Tiles with any bit are appended to the work list (one
// atomic add a block and round).
template <bool COMPOSITE>
__global__ void __launch_bounds__(BIN_THREADS)
bin_kernel(const int* __restrict__ list, const int* __restrict__ count,
           const int* __restrict__ ctrl, int* __restrict__ bins,
           int* __restrict__ work, int* __restrict__ work_len, int list_len,
           int n_faces, int n_words, int height, int width, int tiles_x,
           int n_tiles) {
  __shared__ int s_any[BIN_CHUNK];
  const int inst = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int* ctrl_i = ctrl + (size_t)inst * n_faces * N_CTRL;
  int* bins_i = bins + (size_t)inst * n_tiles * n_words;

  for (int chunk0 = 0; chunk0 < n_tiles; chunk0 += BIN_CHUNK) {
    const int nt = min(BIN_CHUNK, n_tiles - chunk0);
    for (int j = threadIdx.x; j < nt; j += BIN_THREADS) s_any[j] = 0;
    __syncthreads();
    for (int w = warp; w < n_words; w += BIN_THREADS / 32) {
      const int e = 32 * w + lane;
      bool live = false;
      int fid = 0;
      if (e < list_len) {
        if (COMPOSITE) {
          const int* tc = list + ((size_t)inst * list_len + e) * N_TCTRL;
          live = tc[T_VALID] != 0 && tc[T_EA] != 0;
          fid = tc[T_FID];
        } else {
          live = e < count[inst];
          fid = list[(size_t)inst * list_len + e];
        }
      }
      // the tile columns tx_lo..tx_hi and rows ty_lo..ty_hi that hold a
      // pixel of the bbox (half-open, clipped to the frame)
      int tx_lo = 0, tx_hi = -1, ty_lo = 0, ty_hi = -1;
      if (live) {
        const int4 box =
            *reinterpret_cast<const int4*>(ctrl_i + (size_t)fid * N_CTRL);
        const int x_lo = max(box.x, 0), x_hi = min(box.y, width);
        const int y_lo = max(box.z, 0), y_hi = min(box.w, height);
        live = x_hi > x_lo && y_hi > y_lo;
        if (live) {
          tx_lo = x_lo / TILE_W;
          tx_hi = (x_hi - 1) / TILE_W;
          ty_lo = y_lo / TILE_H;
          ty_hi = (y_hi - 1) / TILE_H;
        }
      }
      if (__ballot_sync(FULL, live) == 0u) {   // a word past the live part
        for (int t = lane; t < nt; t += 32)
          bins_i[(size_t)(chunk0 + t) * n_words + w] = 0;
        continue;
      }
      int ty = chunk0 / tiles_x, tx = chunk0 - ty * tiles_x;
      unsigned keep = 0u;
      for (int t = 0; t < nt; ++t) {
        const bool hit = tx >= tx_lo && tx <= tx_hi && ty >= ty_lo &&
                         ty <= ty_hi;
        const unsigned m = __ballot_sync(FULL, hit);
        if (lane == (t & 31)) keep = m;
        if (m != 0u && lane == 0) s_any[t] = 1;
        if ((t & 31) == 31 || t == nt - 1) {
          const int tt = (t & ~31) + lane;
          if (tt <= t) bins_i[(size_t)(chunk0 + tt) * n_words + w] = (int)keep;
        }
        if (++tx == tiles_x) {
          tx = 0;
          ++ty;
        }
      }
    }
    __syncthreads();
    if (work != nullptr && warp == 0) {
      int total = 0;
      for (int base = 0; base < nt; base += 32) {
        const bool any = base + lane < nt && s_any[base + lane] != 0;
        total += __popc(__ballot_sync(FULL, any));
      }
      int at = 0;
      if (lane == 0 && total > 0) at = atomicAdd(work_len, total);
      at = __shfl_sync(FULL, at, 0);
      for (int base = 0; base < nt; base += 32) {
        const bool any = base + lane < nt && s_any[base + lane] != 0;
        const unsigned m = __ballot_sync(FULL, any);
        if (any)
          work[at + __popc(m & ((1u << lane) - 1u))] =
              inst * n_tiles + chunk0 + base + lane;
        at += __popc(m);
      }
    }
    __syncthreads();   // s_any is cleared again
  }
}

// The next entries of a tile's list, for both consumers.  EVERY thread of
// the block calls this (it synchronizes).  Warp 0 reads up to 32 of the
// tile's mask words from `word0` on (one coalesced read), takes whole
// words while their set bits fit into BATCH, and writes the bits' list
// positions, in order, to s_pos.  Returns how many (block-uniform) and
// moves `word0` past the words taken.
__device__ __forceinline__ int next_batch(const int* __restrict__ words,
                                          int n_words, int& word0,
                                          int* s_pos, int* s_hdr,
                                          int t_lin) {
  __syncthreads();   // the previous batch is no longer read
  if (t_lin < 32) {
    const int w = word0 + t_lin;
    unsigned m = w < n_words ? (unsigned)words[w] : 0u;
    const int cnt = __popc(m);
    int incl = cnt;
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(FULL, incl, d);
      if (t_lin >= d) incl += v;
    }
    // the running sum never falls, so the words taken are a prefix; the
    // first always fits (BATCH >= 32)
    const bool take = w < n_words && incl <= BATCH;
    const int n_take = __popc(__ballot_sync(FULL, take));
    if (take) {
      int at = incl - cnt;
      while (m != 0u) {
        s_pos[at++] = 32 * w + (__ffs(m) - 1);
        m &= m - 1u;
      }
    }
    const int n = __shfl_sync(FULL, incl, max(n_take - 1, 0));
    if (t_lin == 0) {
      s_hdr[0] = n_take > 0 ? n : 0;
      s_hdr[1] = word0 + n_take;
    }
  }
  __syncthreads();
  word0 = s_hdr[1];
  return s_hdr[0];
}

// Phase 1.  Grid: (tiles_x, tiles_y, instances); `bins` from bin_kernel
// over (order, count).  PERSP: keyed faces fetch their key texel at the
// perspective-correct UV.
template <bool PAINTERS, bool PERSP>
__global__ void __launch_bounds__(VIS_THREADS,
                                  PERSP ? VIS_MIN_BLOCKS_PERSP : VIS_MIN_BLOCKS)
visibility_kernel(const int* __restrict__ order,
                  const int* __restrict__ ctrl,
                  const float* __restrict__ attrs,
                  const int* __restrict__ tex_data,
                  const int* __restrict__ tex_off,
                  const int* __restrict__ tex_w,
                  const int* __restrict__ tex_h,
                  const int* __restrict__ bins,
                  float* __restrict__ depth_out,
                  int* __restrict__ winner_out,
                  float* __restrict__ bcx_out,
                  float* __restrict__ bcy_out,
                  int n_faces, int n_words, int height, int width) {
  // a record: attrs columns 0..15, then the ctrl row with the face id in
  // place of its first unused column
  __shared__ float4 s_f[BATCH][N_FSCAL / 4];
  __shared__ int4 s_c[BATCH][2];
  __shared__ int s_pos[BATCH];
  __shared__ int s_hdr[2];

  const int inst = blockIdx.z;
  const int t_lin = threadIdx.y * TILE_W + threadIdx.x;
  const int xi = blockIdx.x * TILE_W + threadIdx.x;
  const int y_first = blockIdx.y * TILE_H + threadIdx.y * VIS_ROWS;
  const float px = (float)xi;

  const int* order_i = order + (size_t)inst * n_faces;
  const int* ctrl_i = ctrl + (size_t)inst * n_faces * N_CTRL;
  const float* attrs_i = attrs + (size_t)inst * n_faces * N_COLS;
  const int* words =
      bins + (((size_t)inst * gridDim.y + blockIdx.y) * gridDim.x +
              blockIdx.x) * n_words;

  float depth[VIS_ROWS], best_bcx[VIS_ROWS], best_bcy[VIS_ROWS];
  int winner[VIS_ROWS];
#pragma unroll
  for (int k = 0; k < VIS_ROWS; ++k) {
    depth[k] = best_bcx[k] = best_bcy[k] = 0.0f;
    winner[k] = -1;
  }

  int word0 = 0;
  while (word0 < n_words) {
    const int n = next_batch(words, n_words, word0, s_pos, s_hdr, t_lin);
    for (int j = t_lin; j < n * N_REC4; j += VIS_THREADS) {
      const int f = j / N_REC4, part = j % N_REC4;
      if (part >= 6) continue;
      const int fo = order_i[s_pos[f]];
      if (part < 4) {
        s_f[f][part] = reinterpret_cast<const float4*>(
            attrs_i + (size_t)fo * N_COLS)[part];
      } else {
        int4 v = reinterpret_cast<const int4*>(
            ctrl_i + (size_t)fo * N_CTRL)[part - 4];
        if (part == 5) v.z = fo;
        s_c[f][part - 4] = v;
      }
    }
    __syncthreads();

    for (int f = 0; f < n; ++f) {
      const int4 box = s_c[f][0];   // x_lo, x_hi, y_lo, y_hi
      // coverage is defined inside the clipped bbox; a warp none of whose
      // pixels lies in it skips the face
      if (xi < box.x || xi >= box.y || y_first >= box.w ||
          y_first + VIS_ROWS <= box.z)
        continue;
      const int4 meta = s_c[f][1];  // tid, keyable, face id
      const float4 e0 = s_f[f][0];  // v3x, v3y, a0, b0
      const float4 e1 = s_f[f][1];  // a1, b1, ia, iza
      const float4 e2 = s_f[f][2];  // izb, izc, u0, vv0
      const float dx = px - e0.x;
      const float w0x = e0.z * dx, w1x = e1.x * dx;
#pragma unroll
      for (int k = 0; k < VIS_ROWS; ++k) {
        const int yi = y_first + k;
        if (VIS_ROWS > 1 && (yi < box.z || yi >= box.w)) continue;
        const float dy = (float)yi - e0.y;
        const float w0 = w0x + e0.w * dy;
        const float w1 = w1x + e1.y * dy;
        const float bcx = w0 * e1.z;
        const float bcy = w1 * e1.z;
        const float bcz = (1.0f - bcx) - bcy;
        bool cov = bcx >= COVER_EPS && bcy >= COVER_EPS && bcz >= COVER_EPS;
        if (cov && meta.y) {
          // keyed faces: black texels drop out of coverage before the merge
          const float4 e3 = s_f[f][3];  // u1, vv1, u2, vv2
          float u, v;
          if (PERSP) {
            const float iz = (bcx * e1.w + bcy * e2.x) + bcz * e2.y;
            u = persp3(bcx, bcy, bcz, e2.z, e3.x, e3.z, e1.w, e2.x, e2.y, iz);
            v = persp3(bcx, bcy, bcz, e2.w, e3.y, e3.w, e1.w, e2.x, e2.y, iz);
          } else {
            u = interp3(bcx, bcy, bcz, e2.z, e3.x, e3.z);
            v = interp3(bcx, bcy, bcz, e2.w, e3.y, e3.w);
          }
          const int texel =
              tex_data[texel_index(tex_off, tex_w, tex_h, meta.x, u, v)];
          cov = (texel & 0x7FFF) != 0;
        }
        const float izi = (bcx * e1.w + bcy * e2.x) + bcz * e2.y;
        // painter's: the last covering face wins, whatever its depth
        if (cov && (PAINTERS || izi > depth[k])) {
          depth[k] = izi;
          winner[k] = meta.z;
          best_bcx[k] = bcx;
          best_bcy[k] = bcy;
        }
      }
    }
  }

  if (xi < width) {
#pragma unroll
    for (int k = 0; k < VIS_ROWS; ++k) {
      const int yi = y_first + k;
      if (yi >= height) continue;
      const size_t o = ((size_t)inst * height + yi) * width + xi;
      depth_out[o] = PAINTERS ? 0.0f : depth[k];  // painter's writes none
      winner_out[o] = winner[k];
      bcx_out[o] = best_bcx[k];
      bcy_out[o] = best_bcy[k];
    }
  }
}

// The full sky plane.  Grid: (tiles_x, tiles_y, instances) of sky
// tiles; `tile_words` (I, tiles_y, tiles_x, ceil(n_sky_faces / 32)) or
// null receives each tile's mountain faces.
__global__ void __launch_bounds__(SKY_THREADS, SKY_MIN_BLOCKS)
sky_kernel(const float* __restrict__ skyscal,
           const int* __restrict__ sky_faces, int* __restrict__ color_out,
           int* __restrict__ tile_words, int n_sky_faces, int vpad,
           int height, int width, const __grid_constant__ SkyParams sky) {
  __shared__ SkyTile sh;
  const int inst = blockIdx.z;
  const int xi = blockIdx.x * SKY_TILE_W + threadIdx.x;
  const int y_first = blockIdx.y * SKY_TILE_H + threadIdx.y * SKY_THREAD_ROWS;
  bool inside[SKY_THREAD_ROWS];
  int word[SKY_THREAD_ROWS];
#pragma unroll
  for (int k = 0; k < SKY_THREAD_ROWS; ++k)
    inside[k] = xi < width && y_first + k < height;
  int* words = nullptr;
  if (tile_words != nullptr)
    words = tile_words +
            (((size_t)inst * gridDim.y + blockIdx.y) * gridDim.x +
             blockIdx.x) * ((n_sky_faces + 31) / 32);
  sky_tile(sh, sky, skyscal + (size_t)inst * N_SKY_ROWS * vpad, vpad,
           sky_faces, n_sky_faces, words, height, width, inside, xi, y_first,
           word);
#pragma unroll
  for (int k = 0; k < SKY_THREAD_ROWS; ++k)
    if (inside[k])
      color_out[((size_t)inst * height + y_first + k) * width + xi] =
          word[k];
}

// The colour word of the pixel whose winner is face row `a`; false where
// its texel is keyed out and the background shows.  PERSP: the UV is
// perspective-correct over the winner's 1/z at the pixel, the value phase 1
// merged (same expression, same barycentrics).
template <bool PERSP>
__device__ __forceinline__ bool resolve_pixel(
    const float* __restrict__ a, float bcx, float bcy,
    const int* __restrict__ tex_data, const int* __restrict__ tex_off,
    const int* __restrict__ tex_w, const int* __restrict__ tex_h,
    int shading, int xi, int yi, int& word) {
  const float bcz = (1.0f - bcx) - bcy;
  float u, v;
  if (PERSP) {
    const float izi = (bcx * a[C_IZA] + bcy * a[C_IZB]) + bcz * a[C_IZC];
    u = persp3(bcx, bcy, bcz, a[C_U0], a[C_U1], a[C_U2], a[C_IZA], a[C_IZB],
               a[C_IZC], izi);
    v = persp3(bcx, bcy, bcz, a[C_VV0], a[C_VV1], a[C_VV2], a[C_IZA],
               a[C_IZB], a[C_IZC], izi);
  } else {
    u = interp3(bcx, bcy, bcz, a[C_U0], a[C_U1], a[C_U2]);
    v = interp3(bcx, bcy, bcz, a[C_VV0], a[C_VV1], a[C_VV2]);
  }

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
  float vc[9];
  unpack_vc(vcp, vc);
  int q5[3];
  pixel_q5(c15, vc, a + C_SH, shading, ndith, dither_offset(xi, yi), bcx,
           bcy, bcz, q5);
  word = (255 << 24) | expand_5_to_8(q5[0]) | (expand_5_to_8(q5[1]) << 8) |
         (expand_5_to_8(q5[2]) << 16);
  return true;
}

// Where no face drew: a plane (I, H, W) or, without one, a constant
// word.  Grid: (blocks of 256 pixels of one plane, instances).
template <bool PERSP>
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
               const int* __restrict__ bg_plane,
               int n_faces, int height, int width,
               int shading, int bg_word) {
  const int plane = height * width;
  const int inst = blockIdx.y;
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= plane) return;
  const size_t o = (size_t)inst * plane + pix;
  const int yi = pix / width;
  const int xi = pix % width;

  int word = 0;
  bool drawn = false;
  const int w = winner[o];
  if (w >= 0)
    drawn = resolve_pixel<PERSP>(
        attrs + ((size_t)inst * n_faces + w) * N_COLS, bcx_in[o], bcy_in[o],
        tex_data, tex_off, tex_w, tex_h, shading, xi, yi, word);
  if (!drawn) word = bg_plane != nullptr ? bg_plane[o] : bg_word;
  color_out[o] = word;
}

// The same with the sky where no face drew.  Grid: (tiles_x, tiles_y,
// instances) of sky tiles; a tile whose every pixel a face drew skips
// the sky, and its tables and faces, altogether.
template <bool PERSP>
__global__ void __launch_bounds__(SKY_THREADS, SKY_MIN_BLOCKS)
resolve_sky_kernel(const int* __restrict__ winner,
                   const float* __restrict__ bcx_in,
                   const float* __restrict__ bcy_in,
                   const float* __restrict__ attrs,
                   const int* __restrict__ tex_data,
                   const int* __restrict__ tex_off,
                   const int* __restrict__ tex_w,
                   const int* __restrict__ tex_h,
                   int* __restrict__ color_out,
                   const float* __restrict__ skyscal,
                   const int* __restrict__ sky_faces,
                   int n_faces, int height, int width, int shading,
                   int n_sky_faces, int vpad,
                   const __grid_constant__ SkyParams sky) {
  __shared__ SkyTile sh;
  const int inst = blockIdx.z;
  const int xi = blockIdx.x * SKY_TILE_W + threadIdx.x;
  const int y_first = blockIdx.y * SKY_TILE_H + threadIdx.y * SKY_THREAD_ROWS;
  int word[SKY_THREAD_ROWS];
  bool need[SKY_THREAD_ROWS], any_need = false;
#pragma unroll
  for (int k = 0; k < SKY_THREAD_ROWS; ++k) {
    const int yi = y_first + k;
    const size_t o = ((size_t)inst * height + yi) * width + xi;
    word[k] = 0;
    bool drawn = false;
    if (xi < width && yi < height) {
      const int w = winner[o];
      if (w >= 0)
        drawn = resolve_pixel<PERSP>(
            attrs + ((size_t)inst * n_faces + w) * N_COLS, bcx_in[o],
            bcy_in[o], tex_data, tex_off, tex_w, tex_h, shading, xi, yi,
            word[k]);
    }
    need[k] = xi < width && yi < height && !drawn;
    any_need |= need[k];
  }
  if (__syncthreads_or(any_need)) {   // block-uniform
    int s[SKY_THREAD_ROWS];
    sky_tile(sh, sky, skyscal + (size_t)inst * N_SKY_ROWS * vpad, vpad,
             sky_faces, n_sky_faces, nullptr, height, width, need, xi,
             y_first, s);
#pragma unroll
    for (int k = 0; k < SKY_THREAD_ROWS; ++k)
      if (need[k]) word[k] = s[k];
  }
#pragma unroll
  for (int k = 0; k < SKY_THREAD_ROWS; ++k)
    if (xi < width && y_first + k < height)
      color_out[((size_t)inst * height + y_first + k) * width + xi] =
          word[k];
}

// Phase 3.  ZACTIVE: z-test against the opaque depth (z-buffer mode, not
// x-ray).  XRAY: the 50% average in place of blend modes and editor alpha.
// PERSP: perspective-correct UV over the entry's own 1/z at the pixel.
// A fixed grid strides over the work list of bin_kernel: the (instance,
// tile) pairs that a live entry touches; `bins` is over the composite list.
template <bool ZACTIVE, bool XRAY, bool PERSP>
__global__ void __launch_bounds__(COMP_THREADS)
composite_kernel(const int* __restrict__ tctrl,
                 const float* __restrict__ tfscal,
                 const int* __restrict__ ctrl,
                 const float* __restrict__ attrs,
                 const int* __restrict__ tex_data,
                 const int* __restrict__ tex_off,
                 const int* __restrict__ tex_w,
                 const int* __restrict__ tex_h,
                 const int* __restrict__ bins,
                 const int* __restrict__ work,
                 int* __restrict__ work_state,
                 const float* __restrict__ depth_in,
                 int* __restrict__ color,
                 int n_tr, int n_faces, int n_words, int tiles_x,
                 int n_tiles, int height, int width, int shading) {
  // a record: attrs columns 0..15 and the entry's tfscal row, then the
  // face's bbox and the entry's tid, blend, editor alpha, flags
  __shared__ float4 s_f[BATCH][N_TREC / 4];
  __shared__ int4 s_c[BATCH][2];
  __shared__ int s_pos[BATCH];
  __shared__ int s_hdr[2];
  static_assert(N_TREC / 4 + 1 == N_REC4, "eight 16-byte loads a record");
  __shared__ float s_vc[BATCH][9];   // vertex colours, unpacked
  __shared__ int s_t[BATCH][3];      // the texture's offset, width, height
  __shared__ int s_item;

  const int t_lin = threadIdx.y * TILE_W + threadIdx.x;
  const int n_work = work_state[0];

  for (;;) {
    // tiles differ in work by an order of magnitude: each block draws its
    // next one from the cursor
    __syncthreads();
    if (t_lin == 0) s_item = atomicAdd(work_state + 1, 1);
    __syncthreads();
    const int item = s_item;
    if (item >= n_work) break;
    const int wi = work[item];
    const int inst = wi / n_tiles;
    const int tile = wi - inst * n_tiles;
    const int tile_y = tile / tiles_x;
    const int xi = (tile - tile_y * tiles_x) * TILE_W + threadIdx.x;
    const int y_first = tile_y * TILE_H + threadIdx.y * COMP_ROWS;
    const float px = (float)xi;

    const int* tctrl_i = tctrl + (size_t)inst * n_tr * N_TCTRL;
    const float* tfscal_i = tfscal + (size_t)inst * n_tr * N_TFS;
    const int* ctrl_i = ctrl + (size_t)inst * n_faces * N_CTRL;
    const float* attrs_i = attrs + (size_t)inst * n_faces * N_COLS;
    const int* words = bins + (size_t)wi * n_words;

    // the tile's planes are in flight while its records are staged; the
    // colour goes back only where an entry drew
    int word[COMP_ROWS], dither[COMP_ROWS];
    float zbuf[COMP_ROWS];
    bool drew[COMP_ROWS];
#pragma unroll
    for (int k = 0; k < COMP_ROWS; ++k) {
      const int yi = y_first + k;
      word[k] = 0;
      zbuf[k] = 0.0f;
      drew[k] = false;
      dither[k] = dither_offset(xi, yi);
      if (xi < width && yi < height) {
        const size_t o = ((size_t)inst * height + yi) * width + xi;
        word[k] = color[o];
        if (ZACTIVE) zbuf[k] = depth_in[o];
      }
    }

    int word0 = 0;
    while (word0 < n_words) {
      const int n = next_batch(words, n_words, word0, s_pos, s_hdr, t_lin);
      for (int j = t_lin; j < n * N_REC4; j += COMP_THREADS) {
        const int f = j / N_REC4, part = j % N_REC4;
        const int ent = s_pos[f];
        const int* tc = tctrl_i + (size_t)ent * N_TCTRL;
        const int fid = tc[T_FID];
        if (part < 4) {
          s_f[f][part] = reinterpret_cast<const float4*>(
              attrs_i + (size_t)fid * N_COLS)[part];
        } else if (part < 7) {
          s_f[f][part] = reinterpret_cast<const float4*>(
              tfscal_i + (size_t)ent * N_TFS)[part - 4];
        } else {
          s_c[f][0] = *reinterpret_cast<const int4*>(
              ctrl_i + (size_t)fid * N_CTRL);
          s_c[f][1] = make_int4(tc[T_TID], tc[T_BLEND], tc[T_EA],
                                tc[T_FLAGS]);
          // what the pixel pipeline would redo at every pixel of the entry
          const float* fs = tfscal_i + (size_t)ent * N_TFS;
          const int vcp[3] = {(int)fs[0], (int)fs[1], (int)fs[2]};
          unpack_vc(vcp, s_vc[f]);
          const int tid = max(tc[T_TID], 0);
          s_t[f][0] = tex_off[tid];
          s_t[f][1] = tex_w[tid];
          s_t[f][2] = tex_h[tid];
        }
      }
      __syncthreads();

      for (int f = 0; f < n; ++f) {
        const int4 box = s_c[f][0];   // x_lo, x_hi, y_lo, y_hi
        if (xi < box.x || xi >= box.y || y_first >= box.w ||
            y_first + COMP_ROWS <= box.z)
          continue;
        const int4 c = s_c[f][1];     // tid, blend, editor alpha, flags
        const int c_tid = c.x, c_blend = c.y, c_ea = c.z, c_flags = c.w;
        const float* a = reinterpret_cast<const float*>(s_f[f]);
        const float* fs = a + N_FSCAL;   // (vcp x3,) shade x9
        const float dx = px - a[C_V3X];
#pragma unroll
        for (int k = 0; k < COMP_ROWS; ++k) {
          const int yi = y_first + k;
          if (COMP_ROWS > 1 && (yi < box.z || yi >= box.w)) continue;
          const float dy = (float)yi - a[C_V3Y];
          const float w0 = a[C_A0] * dx + a[C_B0] * dy;
          const float w1 = a[C_A1] * dx + a[C_B1] * dy;
          const float bcx = w0 * a[C_IA];
          const float bcy = w1 * a[C_IA];
          const float bcz = (1.0f - bcx) - bcy;
          const bool cov = bcx >= COVER_EPS && bcy >= COVER_EPS &&
                           bcz >= COVER_EPS;
          if (!cov) continue;
          if (ZACTIVE) {
            const float izi =
                (bcx * a[C_IZA] + bcy * a[C_IZB]) + bcz * a[C_IZC];
            if (!(izi > zbuf[k])) continue;
          }
          float u, v;
          if (PERSP) {
            const float izi =
                (bcx * a[C_IZA] + bcy * a[C_IZB]) + bcz * a[C_IZC];
            u = persp3(bcx, bcy, bcz, a[C_U0], a[C_U1], a[C_U2], a[C_IZA],
                       a[C_IZB], a[C_IZC], izi);
            v = persp3(bcx, bcy, bcz, a[C_VV0], a[C_VV1], a[C_VV2], a[C_IZA],
                       a[C_IZB], a[C_IZC], izi);
          } else {
            u = interp3(bcx, bcy, bcz, a[C_U0], a[C_U1], a[C_U2]);
            v = interp3(bcx, bcy, bcz, a[C_VV0], a[C_VV1], a[C_VV2]);
          }
          const bool textured = c_tid >= 0;
          const int texel =
              tex_data[texel_at(s_t[f][0], s_t[f][1], s_t[f][2], u, v)];
          const bool bt = (c_flags & FLAG_BT) != 0;
          int c15 = textured ? texel : 0x7FFF;
          const bool is_black = ((c15 >> 10) & 0x1F) == 0 &&
                                ((c15 >> 5) & 0x1F) == 0 &&
                                (c15 & 0x1F) == 0;
          if (is_black && bt && textured) continue;   // keyed out: not drawn
          if (c15 == 0 && !bt) c15 = 0x8000;          // drawable black
          int q5[3];
          pixel_q5(c15, s_vc[f], fs + 3, shading, (c_flags & FLAG_DITHER) != 0,
                   dither[k], bcx, bcy, bcz, q5);
          const bool semi = (c15 & STP_BIT) != 0 ||
                            (q5[0] == 0 && q5[1] == 0 && q5[2] == 0);
          int out = 255 << 24;
          for (int ch = 0; ch < 3; ++ch) {
            const int front = expand_5_to_8(q5[ch]);
            const int back = (word[k] >> (8 * ch)) & 255;
            int r;
            if (XRAY) {
              r = (front + back) >> 1;   // operands >= 0: >> 1 is // 2
            } else {
              const int p = (semi && c_blend != BM_OPAQUE)
                                ? blend5(c_blend, front, back) : front;
              // editor-alpha lerp (render.rs:564-628): the // 255 is the
              // f32 multiply trunc(x * f32(1/255)), as in the JAX kernel
              r = c_ea < 255
                      ? (int)truncf((float)(p * c_ea + back * (255 - c_ea)) *
                                    INV255)
                      : p;
            }
            out |= r << (8 * ch);
          }
          word[k] = out;
          drew[k] = true;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < COMP_ROWS; ++k)
      if (drew[k])
        color[((size_t)inst * height + y_first + k) * width + xi] = word[k];
  }
}

// The launches of each entry point, one instantiation per mode.
template <bool PAINTERS, bool PERSP>
int launch_visibility(const int* order, const int* ctrl, const float* attrs,
                      const int* tex_data, const int* tex_off,
                      const int* tex_w, const int* tex_h, const int* bins,
                      float* depth, int* winner, float* bcx, float* bcy,
                      int n_inst, int n_faces, int height, int width,
                      cudaStream_t s) {
  const dim3 block(TILE_W, TILE_H / VIS_ROWS);
  const dim3 grid((width + TILE_W - 1) / TILE_W,
                  (height + TILE_H - 1) / TILE_H, n_inst);
  visibility_kernel<PAINTERS, PERSP><<<grid, block, 0, s>>>(
      order, ctrl, attrs, tex_data, tex_off, tex_w, tex_h, bins, depth,
      winner, bcx, bcy, n_faces, (n_faces + 31) / 32, height, width);
  return (int)cudaGetLastError();
}

template <bool PERSP>
int launch_resolve(const int* winner, const float* bcx, const float* bcy,
                   const float* attrs, const int* tex_data,
                   const int* tex_off, const int* tex_w, const int* tex_h,
                   int* color, const int* bg_plane, const float* skyscal,
                   const int* sky_faces, const SkyParams* sky, int n_inst,
                   int n_faces, int height, int width, int shading,
                   int background, int n_sky_faces, int vpad,
                   cudaStream_t s) {
  if (sky != nullptr) {
    const dim3 grid((width + SKY_TILE_W - 1) / SKY_TILE_W,
                    (height + SKY_TILE_H - 1) / SKY_TILE_H, n_inst);
    resolve_sky_kernel<PERSP>
        <<<grid, dim3(SKY_TILE_W, SKY_TILE_H / SKY_THREAD_ROWS), 0, s>>>(
            winner, bcx, bcy, attrs, tex_data, tex_off, tex_w, tex_h, color,
            skyscal, sky_faces, n_faces, height, width, shading, n_sky_faces,
            vpad, *sky);
  } else {
    const int threads = 256;
    const dim3 grid((height * width + threads - 1) / threads, n_inst);
    resolve_kernel<PERSP><<<grid, threads, 0, s>>>(
        winner, bcx, bcy, attrs, tex_data, tex_off, tex_w, tex_h, color,
        bg_plane, n_faces, height, width, shading, background);
  }
  return (int)cudaGetLastError();
}

// Blocks of `kernel` that fill the card once: the fixed grid that strides
// over a work list.
template <typename K>
int resident_blocks(K kernel, int* out) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        COMP_THREADS, 0);
  *out = sms * per_sm;
  return (int)err;
}

template <bool ZACTIVE, bool XRAY, bool PERSP>
int launch_composite(const int* tctrl, const float* tfscal, const int* ctrl,
                     const float* attrs, const int* tex_data,
                     const int* tex_off, const int* tex_w, const int* tex_h,
                     const int* bins, const int* work, int* work_state,
                     const float* depth, int* color, int n_inst, int n_tr,
                     int n_faces, int height, int width, int shading,
                     cudaStream_t s) {
  static int resident = 0;   // per mode; the same on every card of a host
  if (resident == 0) {
    const int err = resident_blocks(composite_kernel<ZACTIVE, XRAY, PERSP>,
                                    &resident);
    if (err != 0) return err;
    if (resident == 0) return (int)cudaErrorLaunchOutOfResources;
  }
  const int tiles_x = (width + TILE_W - 1) / TILE_W;
  const int n_tiles = tiles_x * ((height + TILE_H - 1) / TILE_H);
  const long long most = (long long)n_inst * n_tiles;
  const int grid = (int)(most < resident ? most : resident);
  composite_kernel<ZACTIVE, XRAY, PERSP>
      <<<grid, dim3(TILE_W, TILE_H / COMP_ROWS), 0, s>>>(
      tctrl, tfscal, ctrl, attrs, tex_data, tex_off, tex_w, tex_h, bins, work,
      work_state, depth, color, n_tr, n_faces, (n_tr + 31) / 32, tiles_x,
      n_tiles, height, width, shading);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bins an ordered list per tile: `bins` (I, tiles_y, tiles_x,
// ceil(list_len / 32)).  composite == 0: `list` is order (I, list_len) and
// position p is live where p < count[i]; else `list` is tctrl
// (I, list_len, 8), live where valid and editor alpha are not 0, and
// `count` is not read.  `work` (I * tiles) and `work_len` (zero on entry)
// receive the flat indices of the tiles with any bit and their number, or
// are null.
int raster_bin(const int* list, const int* count, const int* ctrl, int* bins,
               int* work, int* work_len, int n_inst, int list_len,
               int n_faces, int height, int width, int composite,
               void* stream) {
  const int tiles_x = (width + TILE_W - 1) / TILE_W;
  const int n_tiles = tiles_x * ((height + TILE_H - 1) / TILE_H);
  const int n_words = (list_len + 31) / 32;
  if (n_inst == 0 || n_tiles == 0 || n_words == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (composite) {
    bin_kernel<true><<<n_inst, BIN_THREADS, 0, s>>>(
        list, count, ctrl, bins, work, work_len, list_len, n_faces, n_words,
        height, width, tiles_x, n_tiles);
  } else {
    bin_kernel<false><<<n_inst, BIN_THREADS, 0, s>>>(
        list, count, ctrl, bins, work, work_len, list_len, n_faces, n_words,
        height, width, tiles_x, n_tiles);
  }
  return (int)cudaGetLastError();
}

// `perspective`: keyed faces test their texel at the perspective-correct UV.
int raster_visibility(const int* order, const int* ctrl, const float* attrs,
                      const int* tex_data, const int* tex_off,
                      const int* tex_w, const int* tex_h, const int* bins,
                      float* depth, int* winner, float* bcx, float* bcy,
                      int n_inst, int n_faces, int height, int width,
                      int painters, int perspective, void* stream) {
  if (n_inst == 0 || height == 0 || width == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  auto launch = painters ? (perspective ? &launch_visibility<true, true>
                                        : &launch_visibility<true, false>)
                         : (perspective ? &launch_visibility<false, true>
                                        : &launch_visibility<false, false>);
  return launch(order, ctrl, attrs, tex_data, tex_off, tex_w, tex_h, bins,
                depth, winner, bcx, bcy, n_inst, n_faces, height, width, s);
}

// `bg_plane` (I, H, W) or, with `sky` set, `skyscal` + `sky_faces` replace
// the constant `background` word where no face drew; at most one of the
// two is given.  `perspective`: perspective-correct UVs.
int raster_resolve(const int* winner, const float* bcx, const float* bcy,
                   const float* attrs, const int* tex_data,
                   const int* tex_off, const int* tex_w, const int* tex_h,
                   int* color, const int* bg_plane, const float* skyscal,
                   const int* sky_faces, const SkyParams* sky, int n_inst,
                   int n_faces, int height, int width, int shading,
                   int background, int n_sky_faces, int vpad,
                   int perspective, void* stream) {
  if (sky != nullptr && bg_plane != nullptr) return (int)cudaErrorInvalidValue;
  if (n_inst == 0 || height == 0 || width == 0) return 0;
  auto launch = perspective ? &launch_resolve<true> : &launch_resolve<false>;
  return launch(winner, bcx, bcy, attrs, tex_data, tex_off, tex_w, tex_h,
                color, bg_plane, skyscal, sky_faces, sky, n_inst, n_faces,
                height, width, shading, background, n_sky_faces, vpad,
                (cudaStream_t)stream);
}

// `tile_words` (I, tiles_y, tiles_x, ceil(n_sky_faces / 32)) or null:
// each sky tile's mountain faces, as bits in draw order.
int raster_sky(const float* skyscal, const int* sky_faces,
               const SkyParams* sky, int* color, int* tile_words,
               int n_inst, int n_sky_faces, int vpad, int height, int width,
               void* stream) {
  if (n_inst == 0 || height == 0 || width == 0) return 0;
  const dim3 grid((width + SKY_TILE_W - 1) / SKY_TILE_W,
                  (height + SKY_TILE_H - 1) / SKY_TILE_H, n_inst);
  sky_kernel<<<grid, dim3(SKY_TILE_W, SKY_TILE_H / SKY_THREAD_ROWS), 0,
               (cudaStream_t)stream>>>(skyscal, sky_faces, color, tile_words,
                                       n_sky_faces, vpad, height, width,
                                       *sky);
  return (int)cudaGetLastError();
}

// `bins`, `work`: raster_bin's over the composite list `tctrl`;
// `work_state`: two ints, raster_bin's `work_len` and a cursor that is zero
// on entry and that this launch advances.  `perspective`: perspective-
// correct UVs.
int raster_composite(const int* tctrl, const float* tfscal, const int* ctrl,
                     const float* attrs, const int* tex_data,
                     const int* tex_off, const int* tex_w, const int* tex_h,
                     const int* bins, const int* work, int* work_state,
                     const float* depth, int* color, int n_inst, int n_tr,
                     int n_faces, int height, int width, int shading,
                     int mode, int perspective, void* stream) {
  if (n_inst == 0 || n_tr == 0 || height == 0 || width == 0) return 0;
  decltype(&launch_composite<true, false, false>) launch;
  switch (mode) {
    case MODE_ZBUFFER:
      launch = perspective ? &launch_composite<true, false, true>
                           : &launch_composite<true, false, false>;
      break;
    case MODE_PAINTERS:
      launch = perspective ? &launch_composite<false, false, true>
                           : &launch_composite<false, false, false>;
      break;
    case MODE_XRAY:
      launch = perspective ? &launch_composite<false, true, true>
                           : &launch_composite<false, true, false>;
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return launch(tctrl, tfscal, ctrl, attrs, tex_data, tex_off, tex_w, tex_h,
                bins, work, work_state, depth, color, n_inst, n_tr, n_faces,
                height, width, shading, (cudaStream_t)stream);
}

}  // extern "C"
