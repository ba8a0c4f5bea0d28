// Exact L2 distance transform of a batch of edge masks, for Hopper (sm_90a).
//
// Replaces the TPU kernel cube_slam_tpu/ops/pallas_kernels.py::
// _edt_pass2_kernel (launched by edt_pass2_pallas, wrapped by edt_l2_pallas)
// together with the XLA column pass it consumes
// (cube_slam_tpu/ops/distance_transform.py::_vertical_dist). The detector
// calls it once per frame with a box, on the (bbox, height) samples of that
// frame (models/detector.py, through ops/hopper_kernels.py::edt_l2).
//
//   edges (B, H, W) uint8/bool  ->  out (B, H, W) float32
//   g[b,i,x]  = min_j |i - j| over edges[b,j,x], 1e9 for an empty column
//   D[b,i,x]  = min_u g[b,i,u]^2 + (x - u)^2
//   out       = sqrtf(fminf(D, 1e9f))
//
// What bounds it on this card: the function itself needs a bounded number
// of operations per pixel (the exact lower envelope of Felzenszwalb and
// Huttenlocher, ~20 counting both passes), so its bound is the 5 bytes per
// pixel it must move: 1.54 MB at (1, 480, 640), 0.46 us at 3.35 TB/s. This
// kernel runs the brute-force min-plus instead, B*H*W*W candidates of one
// add and one min, 2*B*H*W^2 operations (393.2 M at (1, 480, 640), as the
// Pallas kernel's CostEstimate counts them): 5.9 us at 67 TFLOP/s FP32 is
// the floor of this algorithm, not of the function. A candidate is one
// FFMA and one FMNMX, and FMNMX issues at half the FP32 rate, so ~12 us is
// what the issue slots allow at 1.98 GHz. The lower envelope is serial
// along a row, so at B*H = 480 rows it would keep few warps per SM busy.
//
// The first design (one thread per column walking H rows down and back up,
// re-reading from global memory, on 5 SMs at B = 1; and a row pass spending
// an integer multiply and an int->float conversion per candidate, with one
// shared load per candidate) ran at 3-4% of the brute-force floor. This
// one:
//
// * column pass: one block of 16 warps per (b, strip of 32 columns).
//   Each thread packs 32 rows of its column into a bitmask (a warp reads 32
//   consecutive edge bytes of a row); a scan over the words of each column
//   gives every word the last edge above it and the first edge below it;
//   then each thread finds, per row, the nearest edge above and below with
//   one __clz / __ffs on its word and writes g^2 once. Nothing is read back
//   from global memory.
// * row pass: flat over work items (row, tile of kTX output columns), two
//   lanes per item, each running half of the source columns; a shuffle
//   combines their minima. At B*H = 480 rows that is ~2,400 warps, in
//   two-warp blocks spread evenly over the SMs. A block stages the rows its
//   items touch in shared memory, padded to a multiple of kS with +inf (an
//   +inf candidate never wins the min). Each lane keeps the running minima
//   of its kTX outputs in registers and reads g^2 kS at a time as float4
//   broadcasts, so one shared load feeds 4*kTX candidates. A candidate is
//   fmaf(d, d, g2[u]) with d a float that steps by exactly 1.0: per kS
//   sources, kTX*kS FFMA + kTX*kS FMNMX + (kTX+kS-1) FADD + kS/4 LDS.128,
//   2.24 issue slots per candidate.
//
// Exactness: W <= 4096 (hopper_kernels._MAX_W), so |d| <= 4095 and d^2 <
// 2^24 is an exact float32 integer. fmaf rounds the exact d*d + g2 once,
// as the float32 add of the exact d^2 does, so every candidate has the bits
// of the plain version's g2 + d^2; min is exact, so any evaluation order
// gives the same bits as ops/distance_transform.py. Built without
// --use_fast_math, so sqrtf is correctly rounded.
//
// The launches run on the caller's stream, allocate nothing and do not
// synchronise; each entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kInf = 1e9f;

constexpr int kColLanes = 32;   // columns per column-pass block, one per lane
constexpr int kColWarps = 16;   // warps per column-pass block

constexpr int kTX = 8;          // output columns per row-pass item
constexpr int kS = 16;          // source columns per step: four float4 loads
constexpr int kRowBlock = 64;   // threads per row-pass block
constexpr int kItems = kRowBlock / 2;  // items per block: two lanes share one

// Block (b, strip) writes its strip's H rows.
// Shared memory: mask[k][lane] bit r = edge at row 32k + r; above[k][lane]
// the last edge row in words < k; below[k][lane] the first edge row in words
// > k (-1 when there is none).
__global__ void __launch_bounds__(kColLanes * kColWarps)
edt_column_pass(const uint8_t* __restrict__ edges, float* __restrict__ g2,
                int H, int W, int strips) {
  extern __shared__ uint32_t col_smem[];
  const int nwords = (H + 31) >> 5;
  uint32_t* mask = col_smem;
  int* above = (int*)(mask + nwords * kColLanes);
  int* below = above + nwords * kColLanes;

  const int lane = threadIdx.x, warp = threadIdx.y;
  const int b = blockIdx.x / strips;
  const int x = (blockIdx.x - b * strips) * kColLanes + lane;
  const bool in = x < W;
  const size_t plane = (size_t)b * H * W;
  const uint8_t* e = edges + plane + x;

  for (int k = warp; k < nwords; k += kColWarps) {
    uint32_t m = 0;
    if (in) {
      const int r0 = k * 32;
      if (r0 + 32 <= H) {
#pragma unroll
        for (int r = 0; r < 32; ++r) m |= (uint32_t)(e[(size_t)(r0 + r) * W] != 0) << r;
      } else {
        for (int r = 0; r < H - r0; ++r) m |= (uint32_t)(e[(size_t)(r0 + r) * W] != 0) << r;
      }
    }
    mask[k * kColLanes + lane] = m;
  }
  __syncthreads();

  // carries between words: a running max down each column, a running min up
  if (warp == 0) {
    int last = -1;
    for (int k = 0; k < nwords; ++k) {
      above[k * kColLanes + lane] = last;
      const uint32_t m = mask[k * kColLanes + lane];
      if (m) last = k * 32 + 31 - __clz(m);
    }
  } else if (warp == 1) {
    int first = -1;
    for (int k = nwords - 1; k >= 0; --k) {
      below[k * kColLanes + lane] = first;
      const uint32_t m = mask[k * kColLanes + lane];
      if (m) first = k * 32 + __ffs(m) - 1;
    }
  }
  __syncthreads();
  if (!in) return;

  float* o = g2 + plane + x;
#pragma unroll 4
  for (int i = warp; i < H; i += kColWarps) {
    const int k = i >> 5, r = i & 31;
    const uint32_t m = mask[k * kColLanes + lane];
    const uint32_t up = m & (0xffffffffu >> (31 - r));  // rows 32k .. i
    const uint32_t dn = m & (0xffffffffu << r);         // rows i .. 32k + 31
    const int a = up ? k * 32 + 31 - __clz(up) : above[k * kColLanes + lane];
    const int c = dn ? k * 32 + __ffs(dn) - 1 : below[k * kColLanes + lane];
    int d = a >= 0 ? i - a : -1;
    if (c >= 0 && (d < 0 || c - i < d)) d = c - i;
    const float g = d < 0 ? kInf : (float)d;
    o[(size_t)i * W] = g * g;
  }
}

// Item p = row * tpr + tile covers output columns [kTX*tile, kTX*tile + kTX)
// of one of the `rows` rows. Lanes 2p' and 2p'+1 of a block run the sources
// [0, Wh) and [Wh, Wp) of its item p' and combine their minima with a
// shuffle: twice the warps of one lane per item, for the same work. Block j
// runs items [j*kItems, (j+1)*kItems), which touch the rows from row_lo on.
// Wp = W rounded up to kS; Wh = half of Wp rounded up to kS.
__global__ void __launch_bounds__(kRowBlock)
edt_row_pass(const float* __restrict__ g2, float* __restrict__ out,
             long long rows, int W, int Wp, int Wh, int tpr) {
  extern __shared__ float4 row_smem[];
  float* srow = (float*)row_smem;

  const long long p0 = (long long)blockIdx.x * kItems;
  const long long items = rows * tpr;
  const long long row_lo = p0 / tpr;
  const long long p_last = min(p0 + kItems, items) - 1;
  const int nrows = (int)(p_last / tpr - row_lo) + 1;

  for (int rr = 0; rr < nrows; ++rr) {
    const float* src = g2 + (size_t)(row_lo + rr) * W;
    float* dst = srow + (size_t)rr * Wp;
    for (int u = threadIdx.x; u < Wp; u += kRowBlock) dst[u] = u < W ? src[u] : INFINITY;
  }
  __syncthreads();

  // a lane past the last item runs no step but still joins the shuffle
  const long long p = p0 + (threadIdx.x >> 1);
  const int half = threadIdx.x & 1;
  const bool valid = p < items;
  const long long row = valid ? p / tpr : row_lo;
  const int x0 = valid ? (int)(p - row * tpr) * kTX : 0;
  const int u_begin = half * Wh;
  const int u_end = valid ? min(u_begin + Wh, Wp) : u_begin;
  const float4* g4 = row_smem + (size_t)(row - row_lo) * (Wp / 4);

  float best[kTX];
#pragma unroll
  for (int j = 0; j < kTX; ++j) best[j] = kInf;
  // e[q] = x0 - u0 + q - (kS - 1): candidate (x0 + j, u0 + s) has d = e[j - s + kS - 1]
  float e[kTX + kS - 1];
#pragma unroll
  for (int q = 0; q < kTX + kS - 1; ++q) e[q] = (float)(x0 - u_begin + q - (kS - 1));

  for (int u0 = u_begin; u0 < u_end; u0 += kS) {
    float g[kS];
#pragma unroll
    for (int v = 0; v < kS / 4; ++v) {
      const float4 q = g4[u0 / 4 + v];
      g[4 * v] = q.x;
      g[4 * v + 1] = q.y;
      g[4 * v + 2] = q.z;
      g[4 * v + 3] = q.w;
    }
#pragma unroll
    for (int s = 0; s < kS; ++s) {
#pragma unroll
      for (int j = 0; j < kTX; ++j) {
        const float d = e[j - s + kS - 1];
        best[j] = fminf(best[j], fmaf(d, d, g[s]));
      }
    }
#pragma unroll
    for (int q = 0; q < kTX + kS - 1; ++q) e[q] -= (float)kS;
  }

#pragma unroll
  for (int j = 0; j < kTX; ++j) best[j] = fminf(best[j], __shfl_xor_sync(0xffffffffu, best[j], 1));
  if (!valid) return;

  // each lane of the pair stores half of the item's kTX outputs, one float4
  constexpr int kHalf = kTX / 2;
  static_assert(kHalf == 4, "the aligned store writes one float4");
  const int xs = x0 + half * kHalf;
  float* o = out + (size_t)row * W + xs;
  float v[kHalf];
#pragma unroll
  for (int j = 0; j < kHalf; ++j) v[j] = sqrtf(fminf(half ? best[kHalf + j] : best[j], kInf));
  // o is 16-byte aligned when W is a multiple of 4 and `out` is (a view
  // with a storage offset may not be)
  if ((W & 3) == 0 && ((uintptr_t)out & 15) == 0 && xs + kHalf <= W) {
    *(float4*)o = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < kHalf; ++j)
      if (xs + j < W) o[j] = v[j];
  }
}

int column_pass(const uint8_t* edges, float* g2, int B, int H, int W, cudaStream_t s) {
  const int strips = (W + kColLanes - 1) / kColLanes;
  const size_t smem = (size_t)((H + 31) / 32) * kColLanes * 3 * sizeof(uint32_t);
  // above 48 KB (H > 4096) the kernel must be allowed its shared memory first
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(edt_column_pass, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  edt_column_pass<<<(unsigned)((long long)B * strips), dim3(kColLanes, kColWarps), smem, s>>>(
      edges, g2, H, W, strips);
  return (int)cudaGetLastError();
}

int row_pass(const float* g2, float* out, long long rows, int W, cudaStream_t s) {
  const int tpr = (W + kTX - 1) / kTX;
  const int Wp = (W + kS - 1) / kS * kS;
  const int Wh = (Wp / kS + 1) / 2 * kS;
  // a block's kItems consecutive items touch at most this many rows: at
  // most 32 KB of shared memory (2 rows at W = 4096), under the 48 KB default
  const long long span = (kItems - 1) / tpr + 2;
  const size_t smem = (size_t)(span < rows ? span : rows) * Wp * sizeof(float);
  const long long blocks = (rows * tpr + kItems - 1) / kItems;
  edt_row_pass<<<(unsigned)blocks, kRowBlock, smem, s>>>(g2, out, rows, W, Wp, Wh, tpr);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// edges: (B, H, W) uint8, g2: (B, H, W) float32 scratch, out: (B, H, W)
// float32, all contiguous on the current device; stream: a cudaStream_t.
int cube_slam_edt_l2(const void* edges, void* g2, void* out, int B, int H, int W,
                     void* stream) {
  const int err = column_pass((const uint8_t*)edges, (float*)g2, B, H, W, (cudaStream_t)stream);
  if (err != 0) return err;
  return row_pass((const float*)g2, (float*)out, (long long)B * H, W, (cudaStream_t)stream);
}

// The two passes alone, for timing each: g2 = g^2 of the column pass, and
// out = the row pass over `rows` rows of g2.
int cube_slam_edt_column_pass(const void* edges, void* g2, int B, int H, int W, void* stream) {
  return column_pass((const uint8_t*)edges, (float*)g2, B, H, W, (cudaStream_t)stream);
}

int cube_slam_edt_row_pass(const void* g2, void* out, int rows, int W, void* stream) {
  return row_pass((const float*)g2, (float*)out, rows, W, (cudaStream_t)stream);
}

}  // extern "C"
