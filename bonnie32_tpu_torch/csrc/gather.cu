// Table gather, hand-written for Hopper (sm_90a).  Built by
// bonnie32_tpu_torch/ops/_cuda.py with nvcc into a shared library with a
// plain C interface, loaded through ctypes by ops/gather.py.
//
// Replaces the TPU kernel bonnie32_tpu/ops/gather_pallas.py
// `select_gather` -> `_kernel`: out[...] = table[clip(idx, 0, A - 1)] for
// a 1-D table of 4-byte elements.  On the TPU a gather is a loop over
// 128-lane groups of the table with a lane gather and a select per group,
// because the hardware gathers only within 128 lanes; on this card a
// thread loads any address, so one thread takes one index.  The element
// type does not matter to the copy: f32 and i32 tables both move as
// 32-bit words.
//
// What bounds it on the H100: bytes.  Each index is read once and each
// output written once, 8 B an element; the table (at most a few hundred
// KB here) stays in L2.  Neighbouring threads read neighbouring indices
// and write neighbouring outputs, so both streams coalesce; the table
// reads are scattered and served by the cache.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void __launch_bounds__(256)
gather_kernel(const uint32_t* __restrict__ table,
              const int* __restrict__ idx, uint32_t* __restrict__ out,
              long long n, int table_size) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int j = min(max(idx[i], 0), table_size - 1);
  out[i] = __ldg(table + j);
}

}  // namespace

extern "C" int select_gather(const void* table, const int* idx, void* out,
                             long long n, int table_size, void* stream) {
  if (n == 0) return 0;
  if (table_size <= 0) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  gather_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)table, idx, (uint32_t*)out, n, table_size);
  return (int)cudaGetLastError();
}
