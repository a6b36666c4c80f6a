// K1 — fused global-scan likelihood for Hopper (sm_90a), on the tensor
// cores.
//
// Replaces thunder_tpu/ops/pallas_likelihood.py `_kernel` (launched by
// `global_scan_fused`). For every (image b, pose n, translation t)
//     logL[b,t,n] = Re sum_p (Q_b T_t)[p] P_n[p] + sum_p E_b[p] |P_n[p]|^2
// is ONE product of reduction depth 3P:
//     A row (b, t)  = [Re(Q_b T_t), -Im(Q_b T_t), E_b]        (bf16)
//     B column n    = [Re P_n,      Im P_n,       |P_n|^2]    (bf16)
// with f32 accumulation (the TPU kernel rounds the same operands to bf16).
// The marginals of the posterior exp(logL) are then reduced in the block.
//
// The kernel reads the caller's tensors as they are: q (B, P) complex64,
// e (B, P) f32, proj (K, R, P) complex64, tra (T, P) complex64 and the
// f32 priors (B, R), (B, T). Nothing is packed or padded in device memory
// beforehand: each block forms both operand tiles itself, rounding to
// bf16 as it stores them to shared memory, and masks the pixel tail
// (p >= P) and the pose tail (r >= R) there.
//
// Block = 2 images x 32 translation rows (M = 64, one wgmma.m64n64k16 row
// block) by a tile of 64 poses of one class, one warpgroup (128 threads).
// A stage covers 32 pixels: k-units [Re | Im | |.|^2] x 4 groups of 8
// pixels, six k16 steps; the block forms stage s + 1 into the other of two
// shared-memory buffers while the wgmmas of stage s run. Both operand
// tiles use the no-swizzle core-matrix layout of hopper.cuh. A warp reads
// 8 rows at a time, four lanes along each row, so its global loads are
// 32-byte runs and its shared stores are free of bank conflicts.
//
// Epilogue in registers and shared memory. The block holds all 32
// translation rows of its chunk, so it takes the EXACT max of logL over
// (t, n) of the chunk per image (pad poses and pad translation rows are
// masked to -3e38 first), and with w = exp(logL - base):
//     wR[b,n] = sum_t pt w,   wT[b,t] = sum_n pr w,   wC = sum_t pt wT.
// T > 32 loops over chunks of 32 translations with a streaming baseline
// between chunks (earlier wR / wT entries rescale). Per-tile outputs, under
// the tile's final baseline: base (B, n_tiles), wr (B, N), wc (B, n_tiles),
// wt (B, n_tiles, T), N = 64 n_tiles. A second kernel of the same call
// merges the tiles exactly (every tile's sums move to the per-image max
// baseline), as ops/likelihood.merge_tiles does in plain PyTorch.
//
// Bound on the H100: 4 B R T P + 2 B R P flops against well under 1 MB of
// operands, so operation-bound (989 TFLOP/s bf16). At the round's shape
// (B = 64, N = 256, T = 30, P = 256) the grid is (4, 32) = 128 blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int IMGS = 2;             // images per block
constexpr int TT = 32;              // translation rows per image per chunk
constexpr int BM = IMGS * TT;       // 64 GEMM rows
constexpr int BN = 64;              // poses per block (GEMM columns)
constexpr int PC = 32;              // pixels per stage
constexpr int GROUPS = PC / 8;      // 8-pixel groups per stage
constexpr int UNITS = 3 * GROUPS;   // 16-byte k-units per row per stage
constexpr int NTHREADS = 128;       // one warpgroup
constexpr int STAGE_U4 = UNITS * BM;  // uint4 per operand stage (12 KB)
constexpr uint32_t LBO = BM * 16;   // next k-unit (BM == BN == 64 rows)
constexpr uint32_t SBO = 8 * 16;    // next 8-row group
constexpr float NEG = -3.0e38f;
constexpr int MERGE_THREADS = 256;

static_assert(BM == BN, "A and B tiles share the descriptor offsets");
static_assert(UNITS % 2 == 0, "a stage is whole k16 steps");
static_assert(NTHREADS / 32 * 8 == TT && BN % 32 == 0 && GROUPS == 4,
              "operand formation: a warp forms 8 rows of one 8-pixel group");

// two floats as a bf16 pair (round to nearest), the first in the low half
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__global__ void __launch_bounds__(NTHREADS) global_scan_kernel(
    const float2* __restrict__ q,        // (B, P)
    const float* __restrict__ e,         // (B, P)
    const float2* __restrict__ proj,     // (K, R, P)
    const float2* __restrict__ tra,      // (T, P)
    const float* __restrict__ prior_r,   // (B, R)
    const float* __restrict__ prior_t,   // (B, T)
    float* __restrict__ base_out,        // (B, n_tiles)
    float* __restrict__ wr_out,          // (B, N)
    float* __restrict__ wc_out,          // (B, n_tiles)
    float* __restrict__ wt_out,          // (B, n_tiles, T)
    int B, int P, int R, int tiles_k, int T) {
  extern __shared__ __align__(128) uint4 smem[];
  uint4* a_s = smem;                     // [2][STAGE_U4]
  uint4* b_s = smem + 2 * STAGE_U4;      // [2][STAGE_U4]
  float* wt_s = reinterpret_cast<float*>(smem + 4 * STAGE_U4);  // IMGS x t_pad
  __shared__ float pr_s[IMGS][BN];
  __shared__ bool valid_s[BN];
  __shared__ float wr_s[IMGS][BN];
  __shared__ float part_s[4][BN];
  __shared__ float red_s[4];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tile = blockIdx.x;
  const int n_tiles = gridDim.x;
  const int N = n_tiles * BN;
  const int r0 = (tile % tiles_k) * BN;  // first pose of the tile
  const float2* proj_k = proj + (long long)(tile / tiles_k) * R * P;
  const int b0 = blockIdx.y * IMGS;
  const int n_s = (P + PC - 1) / PC;
  const int n_tc = (T + TT - 1) / TT;
  const int t_pad = n_tc * TT;
  const int img = warp >> 1;  // image of this thread's accumulator rows
  const int bb = b0 + img;
  const bool img_ok = bb < B;

  for (int i = tid; i < IMGS * BN; i += NTHREADS) {
    const int im = i / BN, n = i % BN;
    pr_s[im][n] = (b0 + im < B && r0 + n < R)
                      ? prior_r[(long long)(b0 + im) * R + r0 + n]
                      : 0.0f;
    wr_s[im][n] = 0.0f;
  }
  for (int i = tid; i < BN; i += NTHREADS) valid_s[i] = r0 + i < R;
  for (int i = tid; i < IMGS * t_pad; i += NTHREADS) wt_s[i] = 0.0f;
  float base = NEG;  // running baseline of this thread's image
  __syncthreads();

  // Operand formation, coalesced: lane = (row r8 = lane / 4, pixel pair
  // jj = lane % 4), so one step of a warp reads 8 rows x 8 pixels (a 64-byte
  // run of each row) and stores 32 bf16 pairs into 32 distinct banks: word
  // jj of the 16-byte unit (section, 8-pixel group g, row).
  const int r8 = lane >> 2, jj = lane & 3;
  const float2 zero2 = make_float2(0.0f, 0.0f);
  // B stage: 64 poses x 32 pixels -> units [Re | Im | |P|^2] x 4 groups
  auto form_b = [&](int s, int buf) {
    uint32_t* dst = reinterpret_cast<uint32_t*>(b_s + buf * STAGE_U4);
#pragma unroll
    for (int pass = 0; pass < BN / 32; ++pass) {
      const int n = pass * 32 + warp * 8 + r8;
      const bool ok = r0 + n < R;
      const float2* row = proj_k + (long long)(ok ? r0 + n : 0) * P;
#pragma unroll
      for (int g = 0; g < GROUPS; ++g) {
        const int p = s * PC + g * 8 + 2 * jj;
        const float2 v0 = (ok && p < P) ? row[p] : zero2;
        const float2 v1 = (ok && p + 1 < P) ? row[p + 1] : zero2;
        dst[(g * BN + n) * 4 + jj] = bf16x2(v0.x, v1.x);
        dst[((GROUPS + g) * BN + n) * 4 + jj] = bf16x2(v0.y, v1.y);
        dst[((2 * GROUPS + g) * BN + n) * 4 + jj] =
            bf16x2(v0.x * v0.x + v0.y * v0.y, v1.x * v1.x + v1.y * v1.y);
      }
    }
  };
  // A stage: 64 rows (image, translation) x 32 pixels, formed in the block;
  // a lane's translation pixels serve both images. Rows of pad
  // translations and pad images are zero (the epilogue masks them).
  auto form_a = [&](int s, int buf, int tc) {
    uint32_t* dst = reinterpret_cast<uint32_t*>(a_s + buf * STAGE_U4);
    const int tl = warp * 8 + r8;  // translation row in the chunk
    const bool t_in = tc * TT + tl < T;
    const float2* trow = tra + (long long)(t_in ? tc * TT + tl : 0) * P;
#pragma unroll
    for (int g = 0; g < GROUPS; ++g) {
      const int p = s * PC + g * 8 + 2 * jj;
      const float2 c0 = (t_in && p < P) ? trow[p] : zero2;
      const float2 c1 = (t_in && p + 1 < P) ? trow[p + 1] : zero2;
#pragma unroll
      for (int im = 0; im < IMGS; ++im) {
        const bool ok = t_in && b0 + im < B;
        const long long o = (long long)(ok ? b0 + im : 0) * P;
        const float2 a0 = (ok && p < P) ? q[o + p] : zero2;
        const float2 a1 = (ok && p + 1 < P) ? q[o + p + 1] : zero2;
        const float e0 = (ok && p < P) ? e[o + p] : 0.0f;
        const float e1 = (ok && p + 1 < P) ? e[o + p + 1] : 0.0f;
        const int m = im * TT + tl;
        dst[(g * BM + m) * 4 + jj] =
            bf16x2(a0.x * c0.x - a0.y * c0.y, a1.x * c1.x - a1.y * c1.y);
        dst[((GROUPS + g) * BM + m) * 4 + jj] =
            bf16x2(-(a0.x * c0.y + a0.y * c0.x), -(a1.x * c1.y + a1.y * c1.x));
        dst[((2 * GROUPS + g) * BM + m) * 4 + jj] = bf16x2(e0, e1);
      }
    }
  };

  for (int tc = 0; tc < n_tc; ++tc) {
    float d[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) d[i] = 0.0f;
    hopper::fence_regs(d);

    form_b(0, 0);
    form_a(0, 0, tc);
    for (int s = 0; s < n_s; ++s) {
      const int cur = s & 1;
      // this stage's stores, visible to wgmma; the wgmmas that read the
      // other buffer (stage s - 1) have finished in every thread
      hopper::fence_async_shared();
      __syncthreads();
      hopper::wgmma_fence();
      const uint4* a_cur = a_s + cur * STAGE_U4;
      const uint4* b_cur = b_s + cur * STAGE_U4;
#pragma unroll
      for (int k = 0; k < UNITS / 2; ++k)
        hopper::wgmma_m64n64k16(d, hopper::desc(a_cur + 2 * k * BM, LBO, SBO),
                                hopper::desc(b_cur + 2 * k * BN, LBO, SBO));
      hopper::wgmma_commit();
      if (s + 1 < n_s) {
        form_b(s + 1, cur ^ 1);
        form_a(s + 1, cur ^ 1, tc);
      }
      hopper::wgmma_wait_all();
      hopper::fence_regs(d);
    }

    // ---- epilogue of this translation chunk
    const int tl0 = (warp & 1) * 16 + (lane >> 2);  // row in image, i = 0
    bool t_ok[2];
    float pt[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int t = tc * TT + tl0 + 8 * i;
      t_ok[i] = t < T;
      pt[i] = (t_ok[i] && img_ok) ? prior_t[(long long)bb * T + t] : 0.0f;
    }
    float mx = NEG;
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = 8 * c + 2 * (lane & 3) + j;
          float& v = d[4 * c + 2 * i + j];
          v = (t_ok[i] && valid_s[col]) ? v : NEG;
          mx = fmaxf(mx, v);
        }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    if (lane == 0) red_s[warp] = mx;
    __syncthreads();
    const float nb = fmaxf(base, fmaxf(red_s[2 * img], red_s[2 * img + 1]));
    const float scale = expf(base - nb);
    base = nb;

    float rs[2] = {0.0f, 0.0f};  // wT rows: sum_n pr w
    float cs[16];                // wR columns: sum_t pt w
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = 8 * c + 2 * (lane & 3) + j;
        const float pr = pr_s[img][col];
        float acc = 0.0f;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float w = expf(d[4 * c + 2 * i + j] - nb);
          rs[i] = fmaf(w, pr, rs[i]);
          acc = fmaf(w, pt[i], acc);
        }
        cs[2 * c + j] = acc;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
    }
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      cs[c] += __shfl_xor_sync(0xffffffffu, cs[c], 4);
      cs[c] += __shfl_xor_sync(0xffffffffu, cs[c], 8);
      cs[c] += __shfl_xor_sync(0xffffffffu, cs[c], 16);
    }
    // earlier chunks' wT entries move to the new baseline; this chunk's
    // entries are disjoint from them
    float* wt_img = wt_s + img * t_pad;
    for (int k = tid & 63; k < tc * TT; k += 64) wt_img[k] *= scale;
    if ((lane & 3) == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) wt_img[tc * TT + tl0 + 8 * i] = rs[i];
    }
    if (lane < 4) {
#pragma unroll
      for (int c = 0; c < 8; ++c)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          part_s[warp][8 * c + 2 * lane + j] = cs[2 * c + j];
    }
    __syncthreads();
    {  // thread tid owns wR entry (tid / 64, tid % 64): its own image
      const int n = tid & 63;
      wr_s[img][n] = wr_s[img][n] * scale + part_s[2 * img][n] +
                     part_s[2 * img + 1][n];
    }
  }

  // ---- per-tile outputs under the tile's final baseline
  __syncthreads();
  float wc = 0.0f;
  if (img_ok) {
    const int n = tid & 63;
    wr_out[(long long)bb * N + tile * BN + n] = wr_s[img][n];
    for (int t = tid & 63; t < T; t += 64) {
      const float v = wt_s[img * t_pad + t];
      wt_out[((long long)bb * n_tiles + tile) * T + t] = v;
      wc = fmaf(v, prior_t[(long long)bb * T + t], wc);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    wc += __shfl_xor_sync(0xffffffffu, wc, off);
  if (lane == 0) red_s[warp] = wc;
  __syncthreads();
  if (img_ok && (tid & 63) == 0) {
    const long long o = (long long)bb * n_tiles + tile;
    wc_out[o] = red_s[2 * img] + red_s[2 * img + 1];
    base_out[o] = base;
  }
}

// The exact cross-tile merge, one block per image: baseline = max over
// tiles; each tile's sums scale by exp(base_tile - baseline); wR is the
// scaled tile entries of real poses, wC and wT sum the scaled tiles of a
// class. Outputs baseline (B,), wC (B, K), wR (B, K, R), wT (B, K, T).
__global__ void __launch_bounds__(MERGE_THREADS) merge_kernel(
    const float* __restrict__ base_p, const float* __restrict__ wr_p,
    const float* __restrict__ wc_p, const float* __restrict__ wt_p,
    float* __restrict__ baseline, float* __restrict__ wc,
    float* __restrict__ wr, float* __restrict__ wt, int K, int R,
    int tiles_k, int T) {
  __shared__ float red_s[MERGE_THREADS / 32];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int n_tiles = K * tiles_k;
  const float* bp = base_p + (long long)b * n_tiles;
  float mx = NEG;
  for (int j = tid; j < n_tiles; j += MERGE_THREADS) mx = fmaxf(mx, bp[j]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if ((tid & 31) == 0) red_s[tid >> 5] = mx;
  __syncthreads();
  mx = red_s[0];
#pragma unroll
  for (int w = 1; w < MERGE_THREADS / 32; ++w) mx = fmaxf(mx, red_s[w]);

  const float* wrb = wr_p + (long long)b * n_tiles * BN;
  for (int i = tid; i < K * R; i += MERGE_THREADS) {
    const int k = i / R, r = i - k * R;
    const int j = k * tiles_k + r / BN;
    wr[(long long)b * K * R + i] = wrb[j * BN + r % BN] * expf(bp[j] - mx);
  }
  const float* wtb = wt_p + (long long)b * n_tiles * T;
  for (int i = tid; i < K * T; i += MERGE_THREADS) {
    const int k = i / T, t = i - k * T;
    float acc = 0.0f;
    for (int jj = 0; jj < tiles_k; ++jj) {
      const int j = k * tiles_k + jj;
      acc = fmaf(wtb[j * T + t], expf(bp[j] - mx), acc);
    }
    wt[(long long)b * K * T + i] = acc;
  }
  for (int k = tid; k < K; k += MERGE_THREADS) {
    float acc = 0.0f;
    for (int jj = 0; jj < tiles_k; ++jj) {
      const int j = k * tiles_k + jj;
      acc = fmaf(wc_p[(long long)b * n_tiles + j], expf(bp[j] - mx), acc);
    }
    wc[(long long)b * K + k] = acc;
  }
  if (tid == 0) baseline[b] = mx;
}

}  // namespace

// tiles: one f32 buffer [base (B, n_tiles) | wr (B, 64 n_tiles) |
// wc (B, n_tiles) | wt (B, n_tiles, T)], n_tiles = K ceil(R / 64);
// outputs baseline (B,), wc (B, K), wr (B, K, R), wt (B, K, T). Launches
// the scan, then the merge.
extern "C" int thunder_global_scan(const void* q, const void* e,
                                   const void* proj, const void* tra,
                                   const void* prior_r, const void* prior_t,
                                   void* tiles, void* baseline, void* wc,
                                   void* wr, void* wt, int B, int P, int K,
                                   int R, int T, void* stream) {
  if (B <= 0 || P <= 0 || K <= 0 || R <= 0 || T <= 0 ||
      (B + IMGS - 1) / IMGS > 65535)
    return (int)cudaErrorInvalidValue;
  const int tiles_k = (R + BN - 1) / BN;
  const long long n_tiles = (long long)K * tiles_k;
  if (n_tiles > 0x7fffffffLL / BN) return (int)cudaErrorInvalidValue;
  const int t_pad = (T + TT - 1) / TT * TT;
  const size_t dyn =
      4 * STAGE_U4 * sizeof(uint4) + (size_t)IMGS * t_pad * sizeof(float);
  // the operand buffers alone are 48 KB, so the dynamic part needs the
  // opt-in; it is raised per device only when a larger T needs more
  static size_t opted[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (dyn > opted[dev]) {
    err = cudaFuncSetAttribute(global_scan_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)dyn);
    if (err != cudaSuccess) return (int)err;
    opted[dev] = dyn;
  }
  float* base_p = (float*)tiles;
  float* wr_p = base_p + (long long)B * n_tiles;
  float* wc_p = wr_p + (long long)B * n_tiles * BN;
  float* wt_p = wc_p + (long long)B * n_tiles;
  const cudaStream_t st = (cudaStream_t)stream;
  dim3 grid((unsigned)n_tiles, (B + IMGS - 1) / IMGS);
  global_scan_kernel<<<grid, NTHREADS, dyn, st>>>(
      (const float2*)q, (const float*)e, (const float2*)proj,
      (const float2*)tra, (const float*)prior_r, (const float*)prior_t,
      base_p, wr_p, wc_p, wt_p, B, P, R, tiles_k, T);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  merge_kernel<<<B, MERGE_THREADS, 0, st>>>(
      base_p, wr_p, wc_p, wt_p, (float*)baseline, (float*)wc, (float*)wr,
      (float*)wt, K, R, tiles_k, T);
  return (int)cudaGetLastError();
}
