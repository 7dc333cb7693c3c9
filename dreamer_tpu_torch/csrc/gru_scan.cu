// T GRU steps with torch nn.GRUCell gate semantics in one launch, the state
// carried in f32 from step to step, with the gate residuals of every step,
// on the tensor cores.
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
// x is bf16 and h f32; the TPU kernel multiplies the f32 h into the bf16
// weights, which the tensor cores cannot: h goes in as two bf16 halves,
// h_hi = bf16(h) and h_lo = bf16(h - h_hi), each product exact to about
// 2^-17 of |h| (TF32 would keep 10 bits).  Sums and gate math in f32.
// Outputs h_seq, r, z, n and hn, each (T, B, H) f32; h_seq[t] is the state
// after step t, and the carry into step t + 1 is that f32 value, not rounded
// (as the TPU kernel's h_carry scratch).
//
// What bounds it on an H100: at the world-model update's form (T 1, 1500
// rows, I 1027, H 600) a launch does 5.55 GFLOP of x products and twice 3.24
// GFLOP of h products (the two halves), 12.0 GFLOP on bf16 inputs, 0.012 ms
// at the tensor-core rate, and moves 30.6 MB (x, h0, the weights, five f32
// outputs), 0.009 ms: operations bound it.  At T 30 x B 50 the recurrence
// does: each step needs the last, and reads all 5.9 MB of weights.
//
// Design: the core in gru_core.cuh, shared with the GRU cell.  At T = 1
// nothing is carried: 32 x 32 tiles of 8 MMA warps, 893 blocks at 1500 rows
// (the few-rows plan up to 64).  At T > 1 a block owns 16 rows for all T
// steps and walks the 32-column groups of each step through a 4-slot ring;
// step t + 1 reads the state that step t wrote to h_seq (a fence and a block
// barrier between them).  Rows are independent across the recurrence, so
// the blocks need no synchronisation: at B = 50, 4 blocks run, each
// streaming all the weights from L2 every step.  A cross-SM column split is
// the next step.

#include "gru_core.cuh"

namespace {

struct ScanIO {
  static constexpr bool kLo = true;
  using HT = float;
  const __nv_bfloat16* x;   // (T, B, I)
  const float* h0;          // (B, H)
  const __nv_bfloat16* wi;  // (3H, Ip), rows r | z | n
  const __nv_bfloat16* wh;  // (3H, Hp), rows r | z | n
  const float* bi;          // (3H,)
  const float* bh;          // (3H,)
  float *h_seq, *r, *z, *n, *hn;  // each (T, B, H)
  int N, T, I, H, Ip, Hp;

  // The state entering step t: h0, then the last step's h' in h_seq.
  __device__ const float* state(int t) const {
    return t == 0 ? h0 : h_seq + (size_t)(t - 1) * N * H;
  }
  __device__ const __nv_bfloat16* x_row(int t, int row) const {
    return x + ((size_t)t * N + row) * I;
  }
  __device__ const float* h_row(int t, int row) const { return state(t) + (size_t)row * H; }
  // Past L1: the state rows are written by this launch.
  __device__ float h_at(int t, int row, int j) const {
    return __ldcg(state(t) + (size_t)row * H + j);
  }
  __device__ void store(int t, int row, int j, const gru::Gates& g) const {
    const size_t o = ((size_t)t * N + row) * H + j;
    h_seq[o] = g.out;
    r[o] = g.r;
    z[o] = g.z;
    n[o] = g.n;
    hn[o] = g.hn;
  }
};

template <int MT, int RW, int CW>
__global__ void __launch_bounds__(gru::kThreads, MT == 1 && CW == 1 ? 2 : 1) gru_scan_kernel(const ScanIO io, const gru::Plan p, const __grid_constant__ CUtensorMap twi,
                const __grid_constant__ CUtensorMap twh) {
  gru::run_block<MT, RW, CW>(io, p, &twi, &twh);
}

template <int MT, int RW, int CW>
cudaError_t launch(const ScanIO& io, const gru::Plan& p, cudaStream_t stream) {
  // The few-rows plan loads its weight boxes by the TMA.
  CUtensorMap twi{}, twh{};
  if (MT == 1 && RW == 1 && CW == 1) {
    cudaError_t err = gru::weight_map(&twi, io.wi, 3 * io.H, io.Ip);
    if (err == cudaSuccess) err = gru::weight_map(&twh, io.wh, 3 * io.H, io.Hp);
    if (err != cudaSuccess) return err;
  }
  static bool attributed = false;
  if (!attributed) {
    const cudaError_t err = gru::allow_smem(gru_scan_kernel<MT, RW, CW>);
    if (err != cudaSuccess) return err;
    attributed = true;
  }
  gru_scan_kernel<MT, RW, CW><<<dim3(p.row_blocks, p.col_blocks), p.threads, p.smem, stream>>>(io, p, twi,
                                                                              twh);
  return cudaGetLastError();
}

}  // namespace

// xs (T, B, I) bf16; h0 (B, H) f32; wi (3H, Ip), wh (3H, Hp) bf16 with Ip, Hp
// the widths rounded up to 8 and the padding zero, 16-byte aligned; bi, bh
// (3H,) f32; h_seq, r, z, n, hn (T, B, H) f32.  Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for shapes it does not take.
extern "C" int dt_gru_scan_forward(const void* xs, const void* h0, const void* wi,
                                   const void* wh, const void* bi, const void* bh,
                                   void* h_seq, void* r, void* z, void* n, void* hn,
                                   int T, int B, int I, int H, int Ip, int Hp,
                                   void* stream) {
  const gru::Plan p = gru::make_plan(B, T, H, true);
  if (!gru::valid(B, T, I, H, Ip, Hp, p)) return (int)cudaErrorInvalidValue;
  ScanIO io;
  io.x = static_cast<const __nv_bfloat16*>(xs);
  io.h0 = static_cast<const float*>(h0);
  io.wi = static_cast<const __nv_bfloat16*>(wi);
  io.wh = static_cast<const __nv_bfloat16*>(wh);
  io.bi = static_cast<const float*>(bi);
  io.bh = static_cast<const float*>(bh);
  io.h_seq = static_cast<float*>(h_seq);
  io.r = static_cast<float*>(r);
  io.z = static_cast<float*>(z);
  io.n = static_cast<float*>(n);
  io.hn = static_cast<float*>(hn);
  io.N = B;
  io.T = T;
  io.I = I;
  io.H = H;
  io.Ip = Ip;
  io.Hp = Hp;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.mt == 1 && p.rw == 1 && p.cw == 1) return (int)launch<1, 1, 1>(io, p, s);
  if (p.mt == 1 && p.rw == 1 && p.cw == 4) return (int)launch<1, 1, 4>(io, p, s);
  if (p.mt == gru::kBigMT && p.rw == 1 && p.cw == 4) return (int)launch<gru::kBigMT, 1, 4>(io, p, s);
  return (int)cudaErrorInvalidValue;
}
