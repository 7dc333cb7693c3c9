// The world model's conv encoder as one fused kernel: uint8 frames to flat
// features.
//
// Replaces: dreamer_tpu/ops/conv_pallas.py, encoder_forward (kernels
// _encoder_kernel and _conv_k4s2p1).
//
//   x = norm[u8], a 256-entry bf16 table of the normalised pixel value
//   4 x [conv k4 / s2 / p1 + bias, SiLU], channels 3 -> c1 -> c2 -> c3 -> c4
//   out = x flattened in (h, w, c) order, bf16
//
// The table is an operand because the paths normalise differently: serving
// rounds u / 255 - 0.5 to bf16 once, as the TPU kernel does; the training
// paths round u / 255 and then the difference, as the JAX package's losses
// compute it in bf16 (ops/conv_cuda.py norm_table).  Products accumulate in
// f32; bias and SiLU are applied in f32 and each layer's output is rounded to
// bf16 once, as in _conv_k4s2p1.
//
// What bounds it on an H100: operations.  A 64x64x3 frame at the flagship
// widths (32, 64, 128, 256) costs 53.5 MFLOP and moves 12 KB in and 8 KB out,
// some 2,600 FLOP per byte, far above the card's 295 FLOP/B balance point.
//
// Design: one block per frame.  The block reads the table into shared memory,
// stages its frame there through it, and runs the four layers with every intermediate in shared
// memory, ping-ponging between two buffers (at the flagship sizes 32 KB and
// 64 KB, the larger being the 32x32x32 output of layer 0; more than 48 KB of
// dynamic shared memory needs cudaFuncSetAttribute before the launch).  Only
// the frame is read from and only the features are written to device memory;
// the weights (1.4 MB in bf16) stay in L2 for all blocks.  Each thread owns
// one output channel of kPix neighbouring pixels, so a weight read from
// L1/L2 is used kPix times, and the threads of a warp, holding neighbouring
// channels of the same pixels, read the same activation from shared memory
// (a broadcast) and neighbouring weights (one coalesced read).  The products
// run on the CUDA cores in f32, not on the tensor cores: mapping the 16 taps
// onto wgmma tiles is the next step for speed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 512;
constexpr int kPix = 4;  // output pixels per thread item

__device__ __forceinline__ float silu(float v) { return v / (1.0f + expf(-v)); }

// out (H/2, W/2, Co) = SiLU(conv_k4s2p1(in (H, W, C), w (4, 4, C, Co)) + b).
// `in` is in shared memory; `out` is in shared or device memory.
__device__ void conv_k4s2p1_silu(const __nv_bfloat16* in, int H, int W, int C,
                                 const __nv_bfloat16* __restrict__ w,
                                 const float* __restrict__ b, int Co,
                                 __nv_bfloat16* out) {
  const int Ho = H / 2, Wo = W / 2, P = Ho * Wo;
  const int groups = (P + kPix - 1) / kPix;
  for (int item = threadIdx.x; item < groups * Co; item += blockDim.x) {
    const int co = item % Co, g = item / Co;
    int oy[kPix], ox[kPix];
    float acc[kPix];
#pragma unroll
    for (int p = 0; p < kPix; ++p) {
      const int pix = min(g * kPix + p, P - 1);
      oy[p] = pix / Wo;
      ox[p] = pix - oy[p] * Wo;
      acc[p] = 0.0f;
    }
    for (int ky = 0; ky < 4; ++ky) {
      for (int kx = 0; kx < 4; ++kx) {
        const __nv_bfloat16* wt = w + (size_t)(ky * 4 + kx) * C * Co + co;
        const __nv_bfloat16* src[kPix];
        bool ok[kPix];
#pragma unroll
        for (int p = 0; p < kPix; ++p) {
          const int iy = 2 * oy[p] - 1 + ky, ix = 2 * ox[p] - 1 + kx;
          ok[p] = iy >= 0 && iy < H && ix >= 0 && ix < W;
          src[p] = in + (ok[p] ? (iy * W + ix) * C : 0);
        }
        for (int ci = 0; ci < C; ++ci) {
          const float wv = __bfloat162float(__ldg(wt + (size_t)ci * Co));
#pragma unroll
          for (int p = 0; p < kPix; ++p) {
            if (ok[p]) acc[p] = fmaf(__bfloat162float(src[p][ci]), wv, acc[p]);
          }
        }
      }
    }
    const float bias = b[co];
#pragma unroll
    for (int p = 0; p < kPix; ++p) {
      const int pix = g * kPix + p;
      if (pix < P) out[(size_t)pix * Co + co] = __float2bfloat16(silu(acc[p] + bias));
    }
  }
}

__global__ void __launch_bounds__(kThreads)
encoder_kernel(const uint8_t* __restrict__ obs,  // (N, H, W, 3)
               const __nv_bfloat16* __restrict__ norm,  // (256,)
               int H, int W, size_t a_elems,
               const __nv_bfloat16* __restrict__ w0, const float* __restrict__ b0, int c1,
               const __nv_bfloat16* __restrict__ w1, const float* __restrict__ b1, int c2,
               const __nv_bfloat16* __restrict__ w2, const float* __restrict__ b2, int c3,
               const __nv_bfloat16* __restrict__ w3, const float* __restrict__ b3, int c4,
               __nv_bfloat16* __restrict__ out) {  // (N, H/16 * W/16 * c4)
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __nv_bfloat16 lut[256];
  __nv_bfloat16* buf_a = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* buf_b = buf_a + a_elems;
  const int n = blockIdx.x;
  const uint8_t* frame = obs + (size_t)n * H * W * 3;
  for (int i = threadIdx.x; i < 256; i += blockDim.x) lut[i] = norm[i];
  __syncthreads();
  for (int i = threadIdx.x; i < H * W * 3; i += blockDim.x) buf_a[i] = lut[frame[i]];
  __syncthreads();
  conv_k4s2p1_silu(buf_a, H, W, 3, w0, b0, c1, buf_b);
  __syncthreads();
  conv_k4s2p1_silu(buf_b, H / 2, W / 2, c1, w1, b1, c2, buf_a);
  __syncthreads();
  conv_k4s2p1_silu(buf_a, H / 4, W / 4, c2, w2, b2, c3, buf_b);
  __syncthreads();
  conv_k4s2p1_silu(buf_b, H / 8, W / 8, c3, w3, b3, c4,
                   out + (size_t)n * (H / 16) * (W / 16) * c4);
}

size_t round8(size_t v) { return (v + 7) / 8 * 8; }

}  // namespace

// obs (N, H, W, 3) u8 with H, W multiples of 16; norm (256,) bf16; w_l (4, 4,
// C_l, C_l+1) bf16 (HWIO); b_l (C_l+1,) f32; out (N, H/16 * W/16 * c4) bf16.
// Returns cudaGetLastError() after the launch.
extern "C" int dt_encoder_forward(const void* obs, const void* norm, const void* w0,
                                  const void* b0, const void* w1, const void* b1,
                                  const void* w2, const void* b2, const void* w3,
                                  const void* b3,
                                  void* out, int N, int H, int W, int c1, int c2,
                                  int c3, int c4, void* stream) {
  // buf_a holds the frame, then layer 1's output; buf_b layer 0's, then layer 2's.
  const size_t a_elems = round8(std::max((size_t)H * W * 3, (size_t)(H / 4) * (W / 4) * c2));
  const size_t b_elems = round8(std::max((size_t)(H / 2) * (W / 2) * c1,
                                    (size_t)(H / 8) * (W / 8) * c3));
  const size_t smem = (a_elems + b_elems) * sizeof(__nv_bfloat16);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        encoder_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  encoder_kernel<<<N, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(obs), static_cast<const __nv_bfloat16*>(norm), H, W,
      a_elems,
      static_cast<const __nv_bfloat16*>(w0), static_cast<const float*>(b0), c1,
      static_cast<const __nv_bfloat16*>(w1), static_cast<const float*>(b1), c2,
      static_cast<const __nv_bfloat16*>(w2), static_cast<const float*>(b2), c3,
      static_cast<const __nv_bfloat16*>(w3), static_cast<const float*>(b3), c4,
      static_cast<__nv_bfloat16*>(out));
  return (int)cudaGetLastError();
}
