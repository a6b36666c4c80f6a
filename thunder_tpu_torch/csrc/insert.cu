// K2 — trilinear gridding insert for Hopper (sm_90a), contiguous rows and
// 16-byte vector atomics.
//
// Replaces thunder_tpu/ops/pallas_insert.py `_kernel` (launched by
// `binned_update`, with `sort_bin_samples` / `sorted_insert_update`). The
// TPU has no vector scatter, so the JAX kernel sorts the samples by voxel
// row, bins them into 512-row windows and accumulates each window with a
// one-hot MXU matmul into a LANE-major (24, R_pad) table, the layout
// Mosaic's (24, WIN) blocks tile. Hopper has f32 atomics in L2 and needs
// neither: a sample's 96-byte row [F.re w8 | F.im w8 | T w8] is added
// with six 16-byte vector atomics (each float4 is four corners of one
// quantity) into a CHANNEL-minor table: the logical (24, R_pad) table with
// strides (1, 24), so row r is the 24 contiguous floats at r * 24
// (ops/insert.new_table). Six neighbouring lanes take one sample, one
// float4 each, so a warp's atomics cover ~5 whole rows of contiguous
// memory (one lane per sample was 1.3x slower at random rows).
// Rows outside [0, R_pad) are dropped, as the JAX scatter drops
// out-of-bounds updates.
//
// Semantics are those of `reference_insert_update`: weights
// (wz * wy) * wx in corner order (dz, dy, dx) binary. Atomic order varies
// from run to run, so sums agree with the plain version up to f32
// reassociation.
//
// Bound on the H100: each sample reads 28 bytes and adds one 96-byte row
// (three 32-byte sectors; the lane-major layout touched 24 sectors 18 MB
// apart). The table (431 MB at the 160 px round) exceeds the 50 MB L2, so
// scattered sector read-modify-writes in device memory bound it at random
// rows. The round's own samples are local but have one hot row: the ring's
// pad pixels (zero values) of every slice land on the centre voxel, 14 %
// of all samples; serialised atomics on that row cost more than the rest
// together, so all-zero float4s are skipped (adding zero is the identity;
// only the sign of a zero sum can differ from the plain version).

#include <cuda_runtime.h>

namespace {

constexpr int LANES = 6;                 // one lane per float4 of a row
constexpr int THREADS = 32 * LANES;      // 32 samples per block

__global__ void __launch_bounds__(THREADS) insert_kernel(
    float* __restrict__ tab, int r_pad, const int* __restrict__ idx,
    const float* __restrict__ fr, const float* __restrict__ fi,
    const float* __restrict__ tv, const float* __restrict__ frac,
    long long n) {
  const long long g = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long i = g / LANES;
  const int part = (int)(g - i * LANES);  // float4 index in the row
  if (i >= n) return;
  const int row = idx[i];
  if (row < 0 || row >= r_pad) return;
  const int q = part >> 1;  // 0: F.re, 1: F.im, 2: T
  const int h = part & 1;   // corners 4h .. 4h + 3, i.e. dz = h
  const float fz = frac[3 * i], fy = frac[3 * i + 1], fx = frac[3 * i + 2];
  const float wz[2] = {1.0f - fz, fz};
  const float wy[2] = {1.0f - fy, fy};
  const float wx[2] = {1.0f - fx, fx};
  const float v = q == 0 ? fr[i] : (q == 1 ? fi[i] : tv[i]);
  float w[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int s = 4 * h + c;
    w[c] = (wz[s >> 2] * wy[(s >> 1) & 1]) * wx[s & 1];
  }
  const float4 add = make_float4(v * w[0], v * w[1], v * w[2], v * w[3]);
  // an all-zero float4 changes nothing (masked pixels, zero-weight
  // images): skipping it keeps them off the row they share
  if (add.x != 0.0f || add.y != 0.0f || add.z != 0.0f || add.w != 0.0f)
    atomicAdd(reinterpret_cast<float4*>(tab + (size_t)row * 24) + part, add);
}

}  // namespace

extern "C" int thunder_insert_update(void* tab, int r_pad, const void* idx,
                                     const void* fr, const void* fi,
                                     const void* tv, const void* frac,
                                     long long n, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const long long blocks = (n * LANES + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  insert_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (float*)tab, r_pad, (const int*)idx, (const float*)fr,
      (const float*)fi, (const float*)tv, (const float*)frac, n);
  return (int)cudaGetLastError();
}
