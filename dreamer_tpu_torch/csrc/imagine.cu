// The whole H-step imagination (the dream of an actor-critic update) as one
// kernel: actor MLP -> tanh-Normal action -> GRU on [z ‖ a] -> dynamics-prior
// MLP -> unimix, gumbel-argmax straight-through one-hot, for every step.
//
// Replaces: dreamer_tpu/ops/imagine_pallas.py, imagine_rollout_pallas
// (kernel _imagine_kernel).  It computes what that kernel computes, with its
// rounding points, not its block structure:
//
//   Dense:          f32 accumulation, rounded to bf16, then the bf16 bias
//                   added in bf16 (_split_dense / _dense_ref)
//   LayerNorm+SiLU: f32 over the true width, fast variance
//                   max(0, E[x^2] - E[x]^2), eps 1e-5, rounded once (_ln_silu)
//   GRU gates:      f32 on the bf16 pre-activations; h' = (1-z) n + z h in f32
//   mu, sigma, a:   f32; sigma = softplus(clip(raw, -5, 2)) + min_std,
//                   a = tanh(mu + sigma * eps)
//   sampling:       f32 softmax, 1% unimix, argmax(log p + gum) with the
//                   first index on ties, z' = (onehot + p) - p in that order
//
// What bounds it on an H100: at the flagship shapes (B 50, T 30, GRU 600,
// 32x32 latents, hiddens 200, 3 actions) a rollout does 2 B T 3.66 M = 11 GFLOP
// (11 us at 989 TFLOP/s) and must move 23 MB (7.3 MB of bf16 weights, 9.8 MB
// of f32 outputs, 6.1 MB of gumbels: 7 us at 3.35 TB/s).  The recurrence is
// the real limit: each of the 30 steps depends on the last, and each reads
// all 7.3 MB of weights.
//
// Design: one block per imagined trajectory, the time loop inside the block.
// h (f32), z (f32), the current Dense input (bf16 values held as f32) and
// every intermediate (actor 200/200, gates 3 x 600 twice, dyn 200/200, 1024
// logits) live in shared memory, about 32 KB at the flagship widths.  The
// weights come in a per-output-row layout made once per weight load (row j of
// a Dense is W[:, j], zero padded to a multiple of 8, as gru_kernel_layout
// makes the GRU's), so that a warp reads one output's row as 16-byte vectors,
// four in flight per lane, and reduces it with shuffles.  The 7.3 MB stay in
// the 50 MB L2 across steps and blocks; the block's time is its SM's L2 read
// rate times 30 steps.  Sampling gives one warp to each latent row, one lane
// to each class (so at most 32 classes).  Only B of the 132 SMs work: the
// cross-SM weight split with a grid barrier, tensor cores and TMA are the
// next steps for speed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kUnroll = 4;  // 16-byte weight loads in flight per lane

struct Dims {
  int B, T, H, Z, rows, classes, A, AH1, AH2, DH1, DH2;
  int K_a0, K_a1, K_head, K_gi, K_gh, K_d0, K_d1, K_d2;  // padded row lengths
  float keep, mix;                                          // 1 - unimix, unimix / classes
  float min_std;
  int off_z, off_x, off_y, off_gi, off_gh, off_red;         // shared-memory offsets (floats)
};

struct Operands {
  const __nv_bfloat16 *a0w, *a1w, *muw, *sgw, *wi, *wh, *d0w, *d1w, *d2w;
  const float *a0b, *al0s, *al0b, *a1b, *al1s, *al1b, *mub, *sgb;
  const float *bi, *bh;
  const float *d0b, *dl0s, *dl0b, *d1b, *dl1s, *dl1b, *d2b;
  const float *h0, *z0, *eps, *gum;
  float *h_seq, *z_seq, *a_seq, *mu_seq, *sig_seq, *h_fin, *z_fin;
};

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ void unpack8(const uint4& v, float* f) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(p[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float sigmoid(float v) { return 1.0f / (1.0f + expf(-v)); }

__device__ __forceinline__ float silu(float v) { return v / (1.0f + expf(-v)); }

// softplus as jax.nn.softplus computes it: logaddexp(v, 0).
__device__ __forceinline__ float softplus(float v) {
  return fmaxf(v, 0.0f) + log1pf(expf(-fabsf(v)));
}

// y[j] = bf16(bf16(sum_k x[k] W[j, k]) + b[j]) for j < N, one warp per row.
// x is in shared memory with Kp (a multiple of 8) entries, zero past the true
// width; W is (N, Kp) bf16; b holds bf16 values as f32.
__device__ void dense(const float* x, int Kp, const __nv_bfloat16* __restrict__ W,
                      const float* __restrict__ b, int N, float* y) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, nwarps = blockDim.x / 32;
  const int chunks = Kp / 8;
  for (int j = warp; j < N; j += nwarps) {
    const uint4* row = reinterpret_cast<const uint4*>(W + (size_t)j * Kp);
    float acc = 0.0f;
    for (int c0 = lane; c0 < chunks; c0 += 32 * kUnroll) {
      uint4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int c = c0 + 32 * u;
        v[u] = c < chunks ? __ldg(row + c) : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int c = c0 + 32 * u;
        if (c < chunks) {
          float w[8];
          unpack8(v[u], w);
          const float4 x0 = *reinterpret_cast<const float4*>(x + 8 * c);
          const float4 x1 = *reinterpret_cast<const float4*>(x + 8 * c + 4);
          acc = fmaf(x0.x, w[0], acc);
          acc = fmaf(x0.y, w[1], acc);
          acc = fmaf(x0.z, w[2], acc);
          acc = fmaf(x0.w, w[3], acc);
          acc = fmaf(x1.x, w[4], acc);
          acc = fmaf(x1.y, w[5], acc);
          acc = fmaf(x1.z, w[6], acc);
          acc = fmaf(x1.w, w[7], acc);
        }
      }
    }
    acc = warp_sum(acc);
    if (lane == 0) y[j] = bf16_round(bf16_round(acc) + b[j]);
  }
}

// The sums of a and b over the block, returned to every thread.
__device__ float2 block_sum2(float a, float b, float* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, nwarps = blockDim.x / 32;
  a = warp_sum(a);
  b = warp_sum(b);
  if (lane == 0) {
    red[warp] = a;
    red[32 + warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    a = lane < nwarps ? red[lane] : 0.0f;
    b = lane < nwarps ? red[32 + lane] : 0.0f;
    a = warp_sum(a);
    b = warp_sum(b);
    if (lane == 0) {
      red[64] = a;
      red[65] = b;
    }
  }
  __syncthreads();
  const float2 r = make_float2(red[64], red[65]);
  __syncthreads();  // red is free again
  return r;
}

// out[0:N] = bf16(SiLU(LayerNorm(y[0:N]))), out zero from N to the next
// multiple of 8.  Statistics in f32 over the true width N.
__device__ void ln_silu(const float* y, int N, const float* __restrict__ scale,
                        const float* __restrict__ bias, float* out, float* red) {
  float s = 0.0f, sq = 0.0f;
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    const float v = y[i];
    s += v;
    sq += v * v;
  }
  const float2 tot = block_sum2(s, sq, red);
  const float mean = tot.x / (float)N;
  const float var = fmaxf(0.0f, tot.y / (float)N - mean * mean);
  const float rs = rsqrtf(var + 1e-5f);
  const int Np = (N + 7) / 8 * 8;
  for (int i = threadIdx.x; i < Np; i += blockDim.x) {
    out[i] = i < N ? bf16_round(silu((y[i] - mean) * (rs * scale[i]) + bias[i])) : 0.0f;
  }
  __syncthreads();
}

// x[0:n] = bf16(src[0:n]), zero from n to the next multiple of 8 (at dst).
__device__ void stage_bf16(const float* src, int n, float* dst) {
  const int np = (n + 7) / 8 * 8;
  for (int i = threadIdx.x; i < np; i += blockDim.x) dst[i] = i < n ? bf16_round(src[i]) : 0.0f;
}

__global__ void __launch_bounds__(kThreads)
imagine_kernel(const Dims d, const Operands o) {
  extern __shared__ __align__(16) float smem[];
  float* h = smem;                // (H) f32 carry
  float* z = smem + d.off_z;      // (Z) f32 carry
  float* x = smem + d.off_x;      // the current Dense input (bf16 values)
  float* y = smem + d.off_y;      // the current Dense output
  float* gi = smem + d.off_gi;    // (3H)
  float* gh = smem + d.off_gh;    // (3H)
  float* red = smem + d.off_red;  // reduction scratch
  const int b = blockIdx.x, tid = threadIdx.x;
  const int H = d.H, Z = d.Z, A = d.A;

  for (int i = tid; i < H; i += blockDim.x) h[i] = o.h0[(size_t)b * H + i];
  for (int i = tid; i < Z; i += blockDim.x) z[i] = o.z0[(size_t)b * Z + i];
  __syncthreads();

  for (int t = 0; t < d.T; ++t) {
    const size_t tb = (size_t)t * d.B + b;
    // The pre-step state, and the actor's input [h ‖ z].
    for (int i = tid; i < H; i += blockDim.x) o.h_seq[tb * H + i] = h[i];
    for (int i = tid; i < Z; i += blockDim.x) o.z_seq[tb * Z + i] = z[i];
    for (int i = tid; i < d.K_a0; i += blockDim.x) {
      x[i] = i < H ? bf16_round(h[i]) : (i < H + Z ? bf16_round(z[i - H]) : 0.0f);
    }
    __syncthreads();

    // ---- actor ----
    dense(x, d.K_a0, o.a0w, o.a0b, d.AH1, y);
    __syncthreads();
    ln_silu(y, d.AH1, o.al0s, o.al0b, x, red);
    dense(x, d.K_a1, o.a1w, o.a1b, d.AH2, y);
    __syncthreads();
    ln_silu(y, d.AH2, o.al1s, o.al1b, x, red);
    dense(x, d.K_head, o.muw, o.mub, A, y);
    dense(x, d.K_head, o.sgw, o.sgb, A, y + A);
    __syncthreads();
    if (tid < A) {
      const float mu = y[tid];
      const float sigma = softplus(fminf(fmaxf(y[A + tid], -5.0f), 2.0f)) + d.min_std;
      const float a = tanhf(mu + sigma * o.eps[tb * A + tid]);
      o.mu_seq[tb * A + tid] = mu;
      o.sig_seq[tb * A + tid] = sigma;
      o.a_seq[tb * A + tid] = a;
      y[2 * A + tid] = a;
    }
    __syncthreads();

    // ---- GRU on [z ‖ a] ----
    for (int i = tid; i < d.K_gi; i += blockDim.x) {
      x[i] = i < Z ? bf16_round(z[i]) : (i < Z + A ? bf16_round(y[2 * A + i - Z]) : 0.0f);
    }
    __syncthreads();
    dense(x, d.K_gi, o.wi, o.bi, 3 * H, gi);
    __syncthreads();
    stage_bf16(h, H, x);
    __syncthreads();
    dense(x, d.K_gh, o.wh, o.bh, 3 * H, gh);
    __syncthreads();
    for (int j = tid; j < d.K_d0; j += blockDim.x) {
      if (j < H) {
        const float r = sigmoid(gi[j] + gh[j]);
        const float zg = sigmoid(gi[H + j] + gh[H + j]);
        const float n = tanhf(gi[2 * H + j] + r * gh[2 * H + j]);
        const float hn = (1.0f - zg) * n + zg * h[j];
        h[j] = hn;
        x[j] = bf16_round(hn);
      } else {
        x[j] = 0.0f;
      }
    }
    __syncthreads();

    // ---- dynamics prior ----
    dense(x, d.K_d0, o.d0w, o.d0b, d.DH1, y);
    __syncthreads();
    ln_silu(y, d.DH1, o.dl0s, o.dl0b, x, red);
    dense(x, d.K_d1, o.d1w, o.d1b, d.DH2, y);
    __syncthreads();
    ln_silu(y, d.DH2, o.dl1s, o.dl1b, x, red);
    dense(x, d.K_d2, o.d2w, o.d2b, Z, y);
    __syncthreads();

    // ---- unimix straight-through sample, one warp per latent row ----
    {
      const int warp = tid / 32, lane = tid % 32, nwarps = blockDim.x / 32;
      const int k = d.classes;
      for (int r = warp; r < d.rows; r += nwarps) {
        const bool on = lane < k;
        const float l = on ? y[r * k + lane] : -INFINITY;
        const float m = warp_max(l);
        const float e = on ? expf(l - m) : 0.0f;
        const float s = warp_sum(e);
        const float p = d.keep * (e / s) + d.mix;
        const float score = on ? logf(p) + o.gum[tb * Z + r * k + lane] : -INFINITY;
        const float best = warp_max(score);
        const int win = warp_min(on && score >= best ? lane : k);
        if (on) {
          const float onehot = lane == win ? 1.0f : 0.0f;
          const float zv = (onehot + p) - p;
          z[r * k + lane] = zv;
        }
      }
    }
    __syncthreads();
  }
  for (int i = tid; i < H; i += blockDim.x) o.h_fin[(size_t)b * H + i] = h[i];
  for (int i = tid; i < Z; i += blockDim.x) o.z_fin[(size_t)b * Z + i] = z[i];
}

int round8(int v) { return (v + 7) / 8 * 8; }

int imax(int a, int b) { return a > b ? a : b; }

}  // namespace

// ptrs: the 26 weight operands in the order of ops/imagine_cuda.py
// (actor a0w a0b al0s al0b a1w a1b al1s al1b muw mub sgw sgb; GRU wi wh bi bh;
// dyn d0w d0b dl0s dl0b d1w d1b dl1s dl1b d2w d2b), then h0 z0 eps gum, then
// the outputs h_seq z_seq a_seq mu_seq sig_seq h_fin z_fin: 37 pointers.
// Weights are bf16 (rows, round8(in)), biases bf16 values as f32, LayerNorm
// scales and biases f32; every other operand f32.
// dims: B T H Z rows classes A AH1 AH2 DH1 DH2.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// shapes the kernel does not take.
extern "C" int dt_imagine_rollout(const void* const* ptrs, const int* dims, float unimix,
                                  float min_std, void* stream) {
  Dims d;
  d.B = dims[0];
  d.T = dims[1];
  d.H = dims[2];
  d.Z = dims[3];
  d.rows = dims[4];
  d.classes = dims[5];
  d.A = dims[6];
  d.AH1 = dims[7];
  d.AH2 = dims[8];
  d.DH1 = dims[9];
  d.DH2 = dims[10];
  if (d.classes < 1 || d.classes > 32 || d.rows * d.classes != d.Z || d.B < 1 ||
      d.T < 1) {
    return (int)cudaErrorInvalidValue;
  }
  d.K_a0 = round8(d.H + d.Z);
  d.K_a1 = round8(d.AH1);
  d.K_head = round8(d.AH2);
  d.K_gi = round8(d.Z + d.A);
  d.K_gh = round8(d.H);
  d.K_d0 = round8(d.H);
  d.K_d1 = round8(d.DH1);
  d.K_d2 = round8(d.DH2);
  d.keep = (float)(1.0 - (double)unimix);
  d.mix = (float)((double)unimix / d.classes);
  d.min_std = min_std;
  const int x_len = imax(imax(d.K_a0, d.K_gi), imax(imax(d.K_a1, d.K_head),
                                                    imax(d.K_d0, imax(d.K_d1, d.K_d2))));
  const int y_len = round8(imax(imax(imax(d.AH1, d.AH2), imax(d.DH1, d.DH2)),
                                imax(d.Z, 3 * d.A)));
  d.off_z = round8(d.H);
  d.off_x = d.off_z + round8(d.Z);
  d.off_y = d.off_x + x_len;
  d.off_gi = d.off_y + y_len;
  d.off_gh = d.off_gi + round8(3 * d.H);
  d.off_red = d.off_gh + round8(3 * d.H);
  const size_t smem = (size_t)(d.off_red + 72) * sizeof(float);

  Operands o;
  int i = 0;
  auto w = [&](void) { return static_cast<const __nv_bfloat16*>(ptrs[i++]); };
  auto f = [&](void) { return static_cast<const float*>(ptrs[i++]); };
  auto out = [&](void) { return static_cast<float*>(const_cast<void*>(ptrs[i++])); };
  o.a0w = w(); o.a0b = f(); o.al0s = f(); o.al0b = f();
  o.a1w = w(); o.a1b = f(); o.al1s = f(); o.al1b = f();
  o.muw = w(); o.mub = f(); o.sgw = w(); o.sgb = f();
  o.wi = w(); o.wh = w(); o.bi = f(); o.bh = f();
  o.d0w = w(); o.d0b = f(); o.dl0s = f(); o.dl0b = f();
  o.d1w = w(); o.d1b = f(); o.dl1s = f(); o.dl1b = f();
  o.d2w = w(); o.d2b = f();
  o.h0 = f(); o.z0 = f(); o.eps = f(); o.gum = f();
  o.h_seq = out(); o.z_seq = out(); o.a_seq = out(); o.mu_seq = out(); o.sig_seq = out();
  o.h_fin = out(); o.z_fin = out();

  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        imagine_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  imagine_kernel<<<d.B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(d, o);
  return (int)cudaGetLastError();
}
