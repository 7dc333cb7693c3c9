// T GRU steps with torch nn.GRUCell gate semantics in one launch, the state
// carried in f32 from step to step, with the gate residuals of every step.
//
// Replaces: dreamer_tpu/ops/gru_pallas.py, gru_scan_forward (kernel
// _gru_scan_kernel, gate math _gate_math).
//
//   r = sigmoid(x.W_ir + h.W_hr + b_ir + b_hr)
//   z = sigmoid(x.W_iz + h.W_hz + b_iz + b_hz)
//   hn = h.W_hn + b_hn
//   n = tanh(x.W_in + b_in + r * hn)
//   h' = (1 - z) * n + z * h
//
// x is bf16 and h f32; the dots accumulate in f32 and the gate math runs in
// f32.  Outputs h_seq, r, z, n and hn, each (T, B, H) f32; h_seq[t] is the
// state after step t, and the carry into step t + 1 is that f32 value, not
// rounded (as the TPU kernel's h_carry scratch).
//
// What bounds it on an H100: at the flagship shapes (I 1027, H 600) one step
// of one row costs 2 * 1800 * 1627 = 5.9 MFLOP against 5.9 MB of bf16
// weights read once per launch.  At the world-model update's form (T 1, 1500
// rows) that is 8.8 GFLOP, of which the h part (3.2 GFLOP) has f32 inputs,
// and 30.6 MB moved (x, h0, the weights, five f32 outputs): operations bound
// it, some 0.054 ms (the x part at the bf16 tensor-core peak, the h part at
// the f32 peak of 67 TFLOP/s).
//
// Design: the weights come in the GRU cell's layout (gru_cuda
// gru_kernel_layout): (3H, K) with gate rows r | z | n and K zero-padded to a
// multiple of 8, so that a warp reads each gate row as contiguous 16-byte
// vectors from L2.  A block owns kRows batch rows for all T steps: it keeps
// their h in shared memory (two f32 buffers, current and next), stages the
// step's x rows there, and gives one hidden column at a time to each warp.
// The warp reads that column's six weight rows once and applies them to all
// kRows rows; lanes split K and a shuffle reduction sums them, in the same
// order as gru_cell.cu, so a T = 1 launch on a bf16-valued h reproduces the
// cell.  Rows are independent across the recurrence, so the blocks need no
// synchronisation; the time loop runs inside the block.  With T = 1 nothing is
// carried, so the launch also splits the hidden columns across blocks
// (kSplitCols each) to fill the card.  At T > 1 and B = 50 only 7 blocks run,
// each re-reading the 5.9 MB of weights from L2 every step: no tensor cores,
// TMA or cross-SM split yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;        // warps per block; each takes one column at a time
constexpr int kRows = 8;         // batch rows per block
constexpr int kSplitCols = 32;   // hidden columns per block when T == 1

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// acc_a[r] += tile[r] . wa (and b, c) over Kp (a multiple of 8), one warp;
// the tile is bf16 (x) or f32 (h), the weights bf16.
template <typename Tile>
__device__ __forceinline__ void load8(const Tile* p, float* f);

template <>
__device__ __forceinline__ void load8<__nv_bfloat16>(const __nv_bfloat16* p, float* f) {
  unpack8(*reinterpret_cast<const uint4*>(p), f);
}

template <>
__device__ __forceinline__ void load8<float>(const float* p, float* f) {
  const float4 u = reinterpret_cast<const float4*>(p)[0];
  const float4 v = reinterpret_cast<const float4*>(p)[1];
  f[0] = u.x; f[1] = u.y; f[2] = u.z; f[3] = u.w;
  f[4] = v.x; f[5] = v.y; f[6] = v.z; f[7] = v.w;
}

template <typename Tile>
__device__ __forceinline__ void dot3(const __nv_bfloat16* __restrict__ wa,
                                     const __nv_bfloat16* __restrict__ wb,
                                     const __nv_bfloat16* __restrict__ wc,
                                     const Tile* tile, int Kp, int lane,
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
      load8<Tile>(tile + (size_t)r * Kp + 8 * c, fx);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        acc_a[r] = fmaf(fx[e], fa[e], acc_a[r]);
        acc_b[r] = fmaf(fx[e], fb[e], acc_b[r]);
        acc_c[r] = fmaf(fx[e], fc[e], acc_c[r]);
      }
    }
  }
}

__global__ void __launch_bounds__(kWarps * 32)
gru_scan_kernel(const __nv_bfloat16* __restrict__ xs,  // (T, B, I)
                const float* __restrict__ h0,          // (B, H)
                const __nv_bfloat16* __restrict__ wi,  // (3H, Ip), rows r | z | n
                const __nv_bfloat16* __restrict__ wh,  // (3H, Hp), rows r | z | n
                const float* __restrict__ bi,          // (3H,)
                const float* __restrict__ bh,          // (3H,)
                float* __restrict__ h_seq, float* __restrict__ r_seq,
                float* __restrict__ z_seq, float* __restrict__ n_seq,
                float* __restrict__ hn_seq,            // each (T, B, H)
                int T, int B, int I, int H, int Ip, int Hp, int cols_per_block) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* h_cur = reinterpret_cast<float*>(smem);                    // (kRows, Hp)
  float* h_next = h_cur + kRows * Hp;                               // (kRows, Hp)
  __nv_bfloat16* xt = reinterpret_cast<__nv_bfloat16*>(h_next + kRows * Hp);  // (kRows, Ip)
  const int row0 = blockIdx.x * kRows;
  const int col0 = blockIdx.y * cols_per_block;
  const int col1 = min(H, col0 + cols_per_block);
  for (int i = threadIdx.x; i < kRows * Hp; i += blockDim.x) {
    const int r = i / Hp, k = i - r * Hp, row = row0 + r;
    h_cur[i] = (row < B && k < H) ? h0[(size_t)row * H + k] : 0.0f;
    h_next[i] = 0.0f;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int t = 0; t < T; ++t) {
    const __nv_bfloat16* x = xs + (size_t)t * B * I;
    for (int i = threadIdx.x; i < kRows * Ip; i += blockDim.x) {
      const int r = i / Ip, k = i - r * Ip, row = row0 + r;
      xt[i] = (row < B && k < I) ? x[(size_t)row * I + k] : __float2bfloat16(0.0f);
    }
    __syncthreads();

    for (int j = col0 + warp; j < col1; j += kWarps) {
      float acc_r[kRows], acc_z[kRows], acc_in[kRows], acc_hn[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc_r[r] = acc_z[r] = acc_in[r] = acc_hn[r] = 0.0f;
      dot3(wi + (size_t)j * Ip, wi + (size_t)(H + j) * Ip, wi + (size_t)(2 * H + j) * Ip,
           xt, Ip, lane, acc_r, acc_z, acc_in);
      dot3(wh + (size_t)j * Hp, wh + (size_t)(H + j) * Hp, wh + (size_t)(2 * H + j) * Hp,
           h_cur, Hp, lane, acc_r, acc_z, acc_hn);

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
        if (lane == r && row < B) {
          const float rg = sigmoid(gr + b_r);
          const float zg = sigmoid(gz + b_z);
          const float hn = ghn + b_hn;
          const float ng = tanhf(gin + b_in + rg * hn);
          const float hv = h_cur[r * Hp + j];
          const float out = (1.0f - zg) * ng + zg * hv;
          const size_t o = ((size_t)t * B + row) * H + j;
          h_seq[o] = out;
          r_seq[o] = rg;
          z_seq[o] = zg;
          n_seq[o] = ng;
          hn_seq[o] = hn;
          h_next[r * Hp + j] = out;
        }
      }
    }
    __syncthreads();
    float* swap = h_cur;
    h_cur = h_next;
    h_next = swap;
  }
}

}  // namespace

// xs (T, B, I) bf16; h0 (B, H) f32; wi (3H, Ip), wh (3H, Hp) bf16 with Ip, Hp
// the widths rounded up to 8 and the padding zero; bi, bh (3H,) f32; h_seq,
// r, z, n, hn (T, B, H) f32.  Returns cudaGetLastError() after the launch.
extern "C" int dt_gru_scan_forward(const void* xs, const void* h0, const void* wi,
                                   const void* wh, const void* bi, const void* bh,
                                   void* h_seq, void* r, void* z, void* n, void* hn,
                                   int T, int B, int I, int H, int Ip, int Hp,
                                   void* stream) {
  const size_t smem = (size_t)kRows * (2 * Hp * sizeof(float) + Ip * sizeof(__nv_bfloat16));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gru_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  // A carried state needs all of a row's columns in one block; a single step
  // carries nothing, so its columns may spread over blocks.
  const int cols = T == 1 ? kSplitCols : H;
  const dim3 grid((B + kRows - 1) / kRows, (H + cols - 1) / cols);
  gru_scan_kernel<<<grid, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(xs), static_cast<const float*>(h0),
      static_cast<const __nv_bfloat16*>(wi), static_cast<const __nv_bfloat16*>(wh),
      static_cast<const float*>(bi), static_cast<const float*>(bh),
      static_cast<float*>(h_seq), static_cast<float*>(r), static_cast<float*>(z),
      static_cast<float*>(n), static_cast<float*>(hn), T, B, I, H, Ip, Hp, cols);
  return (int)cudaGetLastError();
}
