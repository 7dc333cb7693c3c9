// One GRU step with torch nn.GRUCell gate semantics, forward only.
//
// Replaces: dreamer_tpu/ops/gru_pallas.py, gru_cell_pallas / _forward_padded
// (kernel _gru_kernel, gate math _gate_math).  Serving needs no residuals (the
// TPU kernel's r, z, n, hn outputs feed only its backward), so none are kept.
//
//   r = sigmoid(x.W_ir + b_ir + h.W_hr + b_hr)
//   z = sigmoid(x.W_iz + b_iz + h.W_hz + b_hz)
//   n = tanh(x.W_in + b_in + r * (h.W_hn + b_hn))
//   out = (1 - z) * n + z * h
//
// Inputs are bf16; dots accumulate in f32, the gate math runs in f32, and the
// output is rounded to bf16 once, as in _gate_math.
//
// What bounds it on an H100: the gate weights.  At the flagship shapes
// (x 1027 wide, h 600 wide, 3 gates of 600) one launch must read
// (1027 + 600) * 1800 * 2 B = 5.9 MB of weights, about 1.8 us at 3.35 TB/s,
// against a few MFLOP of work for the 1 to 64 rows served.
//
// Design: the weights come in a transposed per-gate layout, (3H, K) with gate
// rows r | z | n and K zero-padded to a multiple of 8, made once when the
// weights are loaded, so that a warp reads each gate row as contiguous 16-byte
// vectors.  A block stages kRows rows of x and h in shared memory and gives
// one hidden column to each warp; the warp reads that column's six weight rows
// once and applies them to all kRows rows, so the weights are read from
// device memory once per row tile (the further row tiles of a 64-row batch
// find them in the 50 MB L2).  Lanes split K, a shuffle reduction sums them,
// and the epilogue is fused.  No tensor cores, TMA or pipelining yet: at 1 to
// 64 rows the launch is a weight stream, and those are the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;  // hidden columns per block, one per warp
constexpr int kRows = 8;   // batch rows per block

__device__ __forceinline__ void unpack8(const uint4& v, float* f) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(p[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ float sigmoid(float v) { return 1.0f / (1.0f + expf(-v)); }

// Stage rows [row0, row0 + kRows) of a (N, K) matrix into a (kRows, Kp) tile,
// zero beyond the matrix.
__device__ void stage(const __nv_bfloat16* __restrict__ src, int N, int K, int Kp,
                      int row0, __nv_bfloat16* tile) {
  for (int i = threadIdx.x; i < kRows * Kp; i += blockDim.x) {
    const int r = i / Kp, k = i - r * Kp, row = row0 + r;
    tile[i] = (row < N && k < K) ? src[(size_t)row * K + k] : __float2bfloat16(0.0f);
  }
}

// acc_a[r] += tile[r] . wa, acc_b[r] += tile[r] . wb, acc_c[r] += tile[r] . wc
// over Kp (a multiple of 8), one warp.
__device__ __forceinline__ void dot3(const __nv_bfloat16* __restrict__ wa,
                                     const __nv_bfloat16* __restrict__ wb,
                                     const __nv_bfloat16* __restrict__ wc,
                                     const __nv_bfloat16* tile, int Kp, int lane,
                                     float* acc_a, float* acc_b, float* acc_c) {
  const uint4* va = reinterpret_cast<const uint4*>(wa);
  const uint4* vb = reinterpret_cast<const uint4*>(wb);
  const uint4* vc = reinterpret_cast<const uint4*>(wc);
  for (int c = lane; c < Kp / 8; c += 32) {
    float fa[8], fb[8], fc[8];
    unpack8(__ldg(va + c), fa);
    unpack8(__ldg(vb + c), fb);
    unpack8(__ldg(vc + c), fc);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float fx[8];
      unpack8(*reinterpret_cast<const uint4*>(tile + (size_t)r * Kp + 8 * c), fx);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        acc_a[r] = fmaf(fx[e], fa[e], acc_a[r]);
        acc_b[r] = fmaf(fx[e], fb[e], acc_b[r]);
        acc_c[r] = fmaf(fx[e], fc[e], acc_c[r]);
      }
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kWarps * 32)
gru_cell_kernel(const __nv_bfloat16* __restrict__ x,   // (N, I)
                const __nv_bfloat16* __restrict__ h,   // (N, H)
                const __nv_bfloat16* __restrict__ wi,  // (3H, Ip), rows r | z | n
                const __nv_bfloat16* __restrict__ wh,  // (3H, Hp), rows r | z | n
                const float* __restrict__ bi,          // (3H,)
                const float* __restrict__ bh,          // (3H,)
                __nv_bfloat16* __restrict__ out,       // (N, H)
                int N, int I, int H, int Ip, int Hp) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);  // (kRows, Ip)
  __nv_bfloat16* hs = xs + kRows * Ip;                          // (kRows, Hp)
  const int row0 = blockIdx.x * kRows;
  stage(x, N, I, Ip, row0, xs);
  stage(h, N, H, Hp, row0, hs);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int j = blockIdx.y * kWarps + warp;
  if (j >= H) return;

  float acc_r[kRows], acc_z[kRows], acc_in[kRows], acc_hn[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc_r[r] = acc_z[r] = acc_in[r] = acc_hn[r] = 0.0f;

  dot3(wi + (size_t)j * Ip, wi + (size_t)(H + j) * Ip, wi + (size_t)(2 * H + j) * Ip,
       xs, Ip, lane, acc_r, acc_z, acc_in);
  dot3(wh + (size_t)j * Hp, wh + (size_t)(H + j) * Hp, wh + (size_t)(2 * H + j) * Hp,
       hs, Hp, lane, acc_r, acc_z, acc_hn);

  const float b_r = bi[j] + bh[j];
  const float b_z = bi[H + j] + bh[H + j];
  const float b_in = bi[2 * H + j];
  const float b_hn = bh[2 * H + j];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float gr = warp_sum(acc_r[r]);
    const float gz = warp_sum(acc_z[r]);
    const float gin = warp_sum(acc_in[r]);
    const float ghn = warp_sum(acc_hn[r]);
    const int row = row0 + r;
    if (lane == r && row < N) {
      const float rg = sigmoid(gr + b_r);
      const float zg = sigmoid(gz + b_z);
      const float ng = tanhf(gin + b_in + rg * (ghn + b_hn));
      const float hv = __bfloat162float(hs[r * Hp + j]);
      out[(size_t)row * H + j] = __float2bfloat16((1.0f - zg) * ng + zg * hv);
    }
  }
}

}  // namespace

// x (N, I), h (N, H), out (N, H) bf16; wi (3H, Ip), wh (3H, Hp) bf16 with
// Ip, Hp the widths rounded up to 8 and the padding zero; bi, bh (3H,) f32.
// Returns cudaGetLastError() after the launch.
extern "C" int dt_gru_cell_forward(const void* x, const void* h, const void* wi,
                                   const void* wh, const void* bi, const void* bh,
                                   void* out, int N, int I, int H, int Ip, int Hp,
                                   void* stream) {
  const size_t smem = (size_t)kRows * (Ip + Hp) * sizeof(__nv_bfloat16);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gru_cell_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((N + kRows - 1) / kRows, (H + kWarps - 1) / kWarps);
  gru_cell_kernel<<<grid, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(h),
      static_cast<const __nv_bfloat16*>(wi), static_cast<const __nv_bfloat16*>(wh),
      static_cast<const float*>(bi), static_cast<const float*>(bh),
      static_cast<__nv_bfloat16*>(out), N, I, H, Ip, Hp);
  return (int)cudaGetLastError();
}
