// The sLSTM recurrence for Hopper (sm_90a): one sLSTM block's scalar-memory
// recurrence, from its input pre-activations to its hidden states, over a
// whole sequence in one launch.
//
// No Pallas kernel computes this. The reference's recurrence is jnp
// (src/repro/models/ssm.py): _slstm_step (:319) under a lax.scan over the
// tokens in slstm_forward (:338-355) and once in slstm_decode (:358). In
// plain PyTorch it is a loop of about fifteen launches a token (the Mamba
// scan's such loop ran 57.0 ms at 512 tokens against the kernel's 0.22),
// so it is a kernel. The plain version is kernels/ref.py: slstm_ref, held
// against this kernel on the card.
//
// The function, for batch b, head h and column e of the head, in f32, over
// t = 0 .. S-1 (D = H * dh; x_pre's last dimension is (gate, head, column)):
//   rec[g]  = sum_d hprev[d] * r[g, h, d, e]                (g: z, i, f, o)
//   pre[g]  = (x_pre[b, t, g*D + h*dh + e] + bias[g*D + h*dh + e]) + rec[g]
//   lf      = log_sigmoid(pre_f) = min(x, 0) - log1p(exp(-|x|))
//   m'      = max(lf + m, pre_i)
//   i_g     = exp(pre_i - m'),  f_g = exp(lf + m - m')
//   c       = f_g * c + i_g * tanh(pre_z)
//   n       = max(f_g * n + i_g, exp(-m'))
//   h       = sigmoid(pre_o) * c / n
// with hs[b, t, h*dh + e] = T(h) (T: x_pre's type, float32 or bfloat16) and
// the final c, n, m, h written in f32. The recurrent h stays f32 from token
// to token; only hs is rounded. exp, log1p and tanh are the full-precision
// expf, log1pf and tanhf (not the __ intrinsics): with the forget bias at 3.0
// log_sigmoid runs near saturation, and its two-sided form keeps it exact
// there. The gate arithmetic is rounded op by op as the plain version's
// (__fmul_rn and __fadd_rn: no contraction into fused multiply-adds); the
// only other difference from the plain version is the order of the sum
// over d (below).
//
// Bound on this card: per token the recurrent product is 8 * dh^2 * H
// operations a batch row (2.1 MFLOP at dh 256, H 4), on the f32 cores at
// 67 TFLOP/s; the bytes (x_pre and hs in the model type, r once, the
// states) come to less (chip_smoke.py: slstm_bytes and slstm_ops). That
// bound assumes every SM at work; the recurrence is serial in t, and B * H
// heads give B * H independent chains. So what sets the time is a token's
// latency along the chain: the product, one block barrier, the gate
// arithmetic on one warp, the stores of h into every block of the cluster
// and one cluster barrier.
//
// Design. A (batch row, head) is a thread-block cluster of dh / CB blocks
// (CB = 32 columns a block: 8 blocks at dh 256; dh 16 and 32 take one block
// of CB = dh). Block q of the cluster owns columns [q*CB, (q+1)*CB) of the
// head for the four gates: its 256 threads, output o = tid % (4*CB) and
// split k = tid / (4*CB), KS = 256 / (4*CB) splits, hold rows
// [k*L, (k+1)*L) (L = dh / KS: 128 at dh 256) of column o of r in
// registers for the whole sequence, read once, coalesced. Every block
// keeps the head's whole h in shared memory, double-buffered. A token:
//   1. each thread sums h[d] * r[d][o] over its rows in four interleaved
//      partials added as (a0 + a1) + (a2 + a3), h read as broadcast
//      float4s; the sum lands in part[k][o];
//   2. one block barrier; then warp 0 (thread e < CB: one column) adds the
//      KS splits in k order, adds (x + bias) + rec, runs the gate
//      arithmetic on its c, n, m (kept in registers for the whole
//      sequence), stores hs, and writes its new h into the next h buffer
//      of every block of the cluster through distributed shared memory;
//      the next token's x_pre was loaded into registers at the start of
//      this one;
//   3. one cluster barrier (it also orders the remote stores before the
//      next token's reads, and keeps every block alive while another may
//      still write into its shared memory).
// Token t reads buffer t & 1 and writes buffer (t + 1) & 1; a block passes
// the barrier of token t - 1 only after every block finished reading buffer
// (t + 1) & 1 in token t - 1, so no write overtakes a read. Fixed summation
// orders and no atomics: two launches are bit-equal. The final state may
// alias the initial one (decode's in-place state): c, n and m are read and
// written by the same thread, and h0 is read into shared memory before the
// first cluster barrier, long before any block writes h_out.
//
// Why r in registers: the first form kept each block's 128 KB of r in
// shared memory and read all of it every token; tools/slstm_sweep.py put
// that product at about 0.78 of its 1.75 us a token step at dh 256 (H100,
// product left out: 0.96 us), the cluster barrier with the remote stores
// at about 0.54 and the gate arithmetic at about 0.09. The same sums in
// the same order from registers give bit-equal results.
//
// A faster design (later work): the cluster barrier replaced by flags
// that each block polls in its own shared memory, or more blocks a head;
// the gate arithmetic overlapped with the next token's product.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as .to(bfloat16)
}

// log(sigmoid(x)) = -softplus(-x) = min(x, 0) - log1p(exp(-|x|))
__device__ __forceinline__ float log_sigmoid(float x) {
  return __fsub_rn(fminf(x, 0.f), log1pf(expf(-fabsf(x))));
}

// The dynamic shared memory of a launch: two h buffers, the partial sums.
constexpr size_t smem_bytes(int dh) {
  return (static_cast<size_t>(2) * dh + kThreads) * sizeof(float);
}

template <typename T, int CB, int DH>
__global__ void __launch_bounds__(kThreads, 1)
slstm_kernel(const T* __restrict__ x_pre, const float* __restrict__ bias,
             const float* __restrict__ r, const float* c0, const float* n0,
             const float* m0, const float* h0, T* __restrict__ hs,
             float* c_out, float* n_out, float* m_out, float* h_out, int S,
             int H) {
  constexpr int NO = 4 * CB;         // outputs a block: 4 gates x CB columns
  constexpr int KS = kThreads / NO;  // partial sums an output
  constexpr int L = DH / KS;         // rows of r a thread holds
  static_assert(L % 4 == 0, "a thread's rows are read as float4 pieces");
  extern __shared__ float4 smem4[];
  float* hbuf = reinterpret_cast<float*>(smem4);  // [2][DH]
  float* part = hbuf + 2 * DH;                    // [KS][NO]

  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int q = static_cast<int>(cluster.block_rank());
  const int head = blockIdx.x / cs;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int D = H * DH;
  const int col0 = q * CB;
  const int o = tid % NO, k = tid / NO;

  // this thread's rows [k*L, (k+1)*L) of column col0 + o % CB of gate
  // o / CB, in registers for the whole sequence (a warp reads 32
  // consecutive columns of a row: coalesced)
  float rr[L];
  {
    const float* src = r + (static_cast<size_t>(o / CB) * H + head) * DH * DH
                       + static_cast<size_t>(k) * L * DH + col0 + o % CB;
#pragma unroll
    for (int j = 0; j < L; ++j) rr[j] = src[static_cast<size_t>(j) * DH];
  }
  const size_t head_off = (static_cast<size_t>(b) * H + head) * DH;
  for (int i = tid; i < DH; i += kThreads) hbuf[i] = h0[head_off + i];

  const bool gate = tid < CB;
  const size_t sidx = head_off + col0 + tid;  // a gate thread's state
  const int colD = head * DH + col0 + tid;    // its column of D
  const size_t row = 4 * static_cast<size_t>(D);
  const T* xrow = x_pre + static_cast<size_t>(b) * S * row + colD;
  T* hrow = hs + static_cast<size_t>(b) * S * D + colD;
  float c = 0.f, n = 0.f, m = 0.f, hv = 0.f;
  float bz = 0.f, bi = 0.f, bf = 0.f, bo = 0.f;
  float xz = 0.f, xi = 0.f, xf = 0.f, xo = 0.f;
  if (gate) {
    c = c0[sidx];
    n = n0[sidx];
    m = m0[sidx];
    bz = bias[colD];
    bi = bias[D + colD];
    bf = bias[2 * D + colD];
    bo = bias[3 * D + colD];
    xz = to_f32(xrow[0]);
    xi = to_f32(xrow[D]);
    xf = to_f32(xrow[2 * D]);
    xo = to_f32(xrow[3 * D]);
  }
  cluster.sync();  // h0 staged; every block of the cluster running

  for (int t = 0; t < S; ++t) {
    const float* hc = hbuf + (t & 1) * DH + k * L;
    float nz = 0.f, ni = 0.f, nf = 0.f, no = 0.f;
    if (gate && t + 1 < S) {  // the next token's pre-activations, in flight
      const T* xp = xrow + (t + 1) * row;
      nz = to_f32(xp[0]);
      ni = to_f32(xp[D]);
      nf = to_f32(xp[2 * D]);
      no = to_f32(xp[3 * D]);
    }
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
    for (int j = 0; j < L; j += 4) {
      const float4 h4 = *reinterpret_cast<const float4*>(hc + j);
      a0 = fmaf(h4.x, rr[j + 0], a0);
      a1 = fmaf(h4.y, rr[j + 1], a1);
      a2 = fmaf(h4.z, rr[j + 2], a2);
      a3 = fmaf(h4.w, rr[j + 3], a3);
    }
    part[k * NO + o] = (a0 + a1) + (a2 + a3);
    __syncthreads();
    if (gate) {
      float rec[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        float s = part[g * CB + tid];
#pragma unroll
        for (int kk = 1; kk < KS; ++kk) s += part[kk * NO + g * CB + tid];
        rec[g] = s;
      }
      const float pz = __fadd_rn(__fadd_rn(xz, bz), rec[0]);
      const float pi = __fadd_rn(__fadd_rn(xi, bi), rec[1]);
      const float pf = __fadd_rn(__fadd_rn(xf, bf), rec[2]);
      const float po = __fadd_rn(__fadd_rn(xo, bo), rec[3]);
      const float lf = log_sigmoid(pf);
      const float lfm = __fadd_rn(lf, m);
      const float mn = fmaxf(lfm, pi);
      const float ig = expf(__fsub_rn(pi, mn));
      const float fg = expf(__fsub_rn(lfm, mn));
      c = __fadd_rn(__fmul_rn(fg, c), __fmul_rn(ig, tanhf(pz)));
      n = fmaxf(__fadd_rn(__fmul_rn(fg, n), ig), expf(-mn));
      const float og = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-po)));
      hv = __fdiv_rn(__fmul_rn(og, c), n);
      m = mn;
      hrow[static_cast<size_t>(t) * D] = from_f32<T>(hv);
      float* nb = hbuf + ((t + 1) & 1) * DH + col0 + tid;
      for (int rk = 0; rk < cs; ++rk) *cluster.map_shared_rank(nb, rk) = hv;
      xz = nz;
      xi = ni;
      xf = nf;
      xo = no;
    }
    cluster.sync();
  }
  if (gate) {
    c_out[sidx] = c;
    n_out[sidx] = n;
    m_out[sidx] = m;
    h_out[sidx] = hv;
  }
}

// Whether the kernel has an instance for a head dim: 16 and 32 (one block
// a head, CB = dh), 64, 128 and 256 (clusters of dh / 32 blocks).
bool takes(int dh) {
  return dh == 16 || dh == 32 || dh == 64 || dh == 128 || dh == 256;
}

// Calls f.template operator()<CB, DH>() for the head dim's instance.
template <typename F>
cudaError_t with_instance(int dh, F&& f) {
  switch (dh) {
    case 16:
      return f.template operator()<16, 16>();
    case 32:
      return f.template operator()<32, 32>();
    case 64:
      return f.template operator()<32, 64>();
    case 128:
      return f.template operator()<32, 128>();
    case 256:
      return f.template operator()<32, 256>();
    default:
      return cudaErrorInvalidValue;
  }
}

cudaLaunchConfig_t config_of(int cs, int H, int B, size_t smem,
                             cudaStream_t st, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs * H, B, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cs;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename T>
struct Launch {
  const void *x_pre, *bias, *r, *c0, *n0, *m0, *h0;
  void *hs, *c_out, *n_out, *m_out, *h_out;
  int B, S, H;
  cudaStream_t st;

  template <int CB, int DH>
  cudaError_t operator()() const {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg =
        config_of(DH / CB, H, B, smem_bytes(DH), st, &attr);
    const cudaError_t err = cudaLaunchKernelEx(
        &cfg, slstm_kernel<T, CB, DH>, static_cast<const T*>(x_pre),
        static_cast<const float*>(bias), static_cast<const float*>(r),
        static_cast<const float*>(c0), static_cast<const float*>(n0),
        static_cast<const float*>(m0), static_cast<const float*>(h0),
        static_cast<T*>(hs), static_cast<float*>(c_out),
        static_cast<float*>(n_out), static_cast<float*>(m_out),
        static_cast<float*>(h_out), S, H);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
  }
};

template <typename T>
struct Plan {
  int* plan;

  template <int CB, int DH>
  cudaError_t operator()() const {
    const int cs = DH / CB;
    const size_t smem = smem_bytes(DH);
    cudaFuncAttributes fa;
    cudaError_t err = cudaFuncGetAttributes(&fa, slstm_kernel<T, CB, DH>);
    if (err != cudaSuccess) return err;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, slstm_kernel<T, CB, DH>, kThreads, smem);
    if (err != cudaSuccess) return err;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = config_of(cs, 1, 1, smem, nullptr, &attr);
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, slstm_kernel<T, CB, DH>,
                                         &cfg);
    if (err != cudaSuccess) return err;
    plan[0] = cs;
    plan[1] = CB;
    plan[2] = kThreads;
    plan[3] = kThreads / (4 * CB);
    plan[4] = fa.numRegs;
    plan[5] = static_cast<int>(smem);
    plan[6] = blocks;
    plan[7] = clusters;
    return cudaSuccess;
  }
};

}  // namespace

// x_pre (B, S, 4 * H * dh) in the model type (dtype 0: float32, 1:
// bfloat16), bias (4 * H * dh) f32, r (4, H, dh, dh) f32, c0, n0, m0, h0
// (B, H, dh) f32, all contiguous; hs (B, S, H * dh) in
// the model type and c_out, n_out, m_out, h_out (B, H, dh) f32 out (they
// may alias c0, n0, m0, h0). Returns a CUDA error code:
// cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int slstm_launch(const void* x_pre, const void* bias,
                            const void* r, const void* c0, const void* n0,
                            const void* m0, const void* h0, void* hs,
                            void* c_out, void* n_out, void* m_out,
                            void* h_out, int B, int S, int H, int dh,
                            int dtype, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || H <= 0 || !takes(dh)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) {
    err = with_instance(dh, Launch<float>{x_pre, bias, r, c0, n0, m0, h0, hs,
                                          c_out, n_out, m_out, h_out, B, S,
                                          H, st});
  } else if (dtype == 1) {
    err = with_instance(dh, Launch<__nv_bfloat16>{
                                x_pre, bias, r, c0, n0, m0, h0, hs, c_out,
                                n_out, m_out, h_out, B, S, H, st});
  }
  return static_cast<int>(err);
}

// The launch geometry of the (dh, dtype) instance into plan[8]: blocks a
// cluster (a head), columns a block, threads a block, splits of the sum
// over d, registers a thread, dynamic shared memory a block (bytes),
// blocks an SM holds, and clusters the card holds at once
// (cudaOccupancyMaxActiveClusters). Returns a CUDA error code.
extern "C" int slstm_plan(int dh, int dtype, int* plan) {
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) err = with_instance(dh, Plan<float>{plan});
  if (dtype == 1) err = with_instance(dh, Plan<__nv_bfloat16>{plan});
  return static_cast<int>(err);
}
