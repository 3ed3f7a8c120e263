// Flash attention forward with GQA and causal masking, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ray_tpu/ops/flash_attention.py
// (_flash_kernel, reached through _flash_forward and the flash_attention
// custom_vjp).  q [B, S, H, D], k/v [B, T, Hkv, D]; query head h reads kv
// head h / (H / Hkv).  The [S, T] score matrix never reaches device memory.
//
// Design.  One thread block per (64-row query tile, head, batch).  Pallas's
// sequential kv grid dimension becomes a loop over 64-row kv tiles inside
// the block: each tile's K rows, then its V rows, are staged in shared
// memory (one buffer, reused), and the scores, the running max and
// denominator and the output accumulator stay in fp32 registers.  A thread
// owns a 4 x 4 patch of the score tile and a 4 x (D / 16) patch of the
// output, so each shared-memory read feeds several FMAs; rows of K are
// padded by one float so the column-strided reads hit distinct banks.  For
// causal attention the loop stops at the diagonal tile — the Pallas
// pl.when skip of tiles wholly above the diagonal, now a loop bound — and
// positions k > q are masked with -1e30 inside it.  The finalize divides by
// the denominator clamped at 1e-20, as the reference does.
//
// Bound.  Causal prefill at S = 2048, H = 32, Hkv = 8 does ~800 FLOPs per
// byte of q/k/v/out in bf16, above the card's ~295 FLOPs/byte ridge, so it
// is bound by operations (989 TFLOP/s bf16 on the tensor cores).  This
// first version runs both products on the fp32 CUDA cores (67 TFLOP/s
// peak) and sits far from that bound; moving them onto wgmma with TMA-fed
// tiles is the known next step.
#include "common.cuh"

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // kv rows per tile
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 score patch each

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int s_len,
                 int t_len, int heads, int kv_heads, float scale, int causal) {
  constexpr int DP = D + 1;       // padded row of q and k/v tiles
  constexpr int PP = kBK + 1;     // padded row of the probability tile
  constexpr int NC = D / 16;      // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;               // [BQ][D + 1]
  float* kv = qs + kBQ * DP;      // [BK][D + 1]: K tile, then V tile
  float* ps = kv + kBK * DP;      // [BQ][BK + 1]

  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;  // heavy
  const int h = blockIdx.y;                                 // tiles first
  const int b = blockIdx.z;
  const int kvh = h / (heads / kv_heads);
  const int tid = threadIdx.x;
  const int ty = tid / 16;  // rows ty * 4 .. + 3
  const int tx = tid % 16;  // score cols tx + 16 j; output cols tx + 16 j
  const int q0 = qt * kBQ;

  const size_t q_row = static_cast<size_t>(heads) * D;      // stride of s
  const size_t kv_row = static_cast<size_t>(kv_heads) * D;  // stride of t
  const T* qb = q + (static_cast<size_t>(b) * s_len + q0) * q_row +
                static_cast<size_t>(h) * D;
  const T* kb = k + static_cast<size_t>(b) * t_len * kv_row +
                static_cast<size_t>(kvh) * D;
  const T* vb = v + static_cast<size_t>(b) * t_len * kv_row +
                static_cast<size_t>(kvh) * D;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D;
    const int c = i - r * D;
    qs[r * DP + c] = rt::to_float(qb[r * q_row + c]);
  }

  float acc[4][NC];
  float m[4];
  float l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = rt::kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;
  }

  int n_tiles = t_len / kBK;
  if (causal) n_tiles = min(n_tiles, (q0 + kBQ - 1) / kBK + 1);

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int t0 = kt * kBK;
    __syncthreads();  // previous tile's V reads are done
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D;
      const int c = i - r * D;
      kv[r * DP + c] = rt::to_float(kb[(t0 + r) * kv_row + c]);
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float qa[4];
      float kc[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = qs[(ty * 4 + i) * DP + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kc[j] = kv[(tx + 16 * j) * DP + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kc[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mx = rt::kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = !causal || t0 + tx + 16 * j <= qpos;
        s[i][j] = ok ? s[i][j] * scale : rt::kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = rt::group_max<16>(mx);
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = !causal || t0 + tx + 16 * j <= qpos;
        const float p = ok ? expf(s[i][j] - m_new) : 0.f;
        ps[(ty * 4 + i) * PP + tx + 16 * j] = p;
        sum += p;
      }
      sum = rt::group_sum<16>(sum);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[i][j] *= corr;
    }
    __syncthreads();  // K reads done, probabilities visible

    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D;
      const int c = i - r * D;
      kv[r * DP + c] = rt::to_float(vb[(t0 + r) * kv_row + c]);
    }
    __syncthreads();

#pragma unroll 4
    for (int t = 0; t < kBK; ++t) {
      float pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = ps[(ty * 4 + i) * PP + t];
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const float vv = kv[t * DP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pa[i], vv, acc[i][j]);
      }
    }
  }

  T* ob = out + (static_cast<size_t>(b) * s_len + q0) * q_row +
          static_cast<size_t>(h) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float inv = 1.f / fmaxf(l[i], 1e-20f);
#pragma unroll
    for (int j = 0; j < NC; ++j)
      ob[(ty * 4 + i) * q_row + tx + 16 * j] =
          rt::from_float<T>(acc[i][j] * inv);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int batch, int s_len, int t_len, int heads, int kv_heads,
                   float scale, int causal, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((kBQ + kBK) * (D + 1) + kBQ * (kBK + 1));
  cudaError_t err = rt::allow_smem(flash_fwd_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(s_len / kBQ, heads, batch);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), s_len, t_len, heads,
      kv_heads, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int d, const void* q, const void* k, const void* v,
                     void* out, int batch, int s_len, int t_len, int heads,
                     int kv_heads, float scale, int causal,
                     cudaStream_t stream) {
  switch (d) {
    case 64:
      return launch<T, 64>(q, k, v, out, batch, s_len, t_len, heads, kv_heads,
                           scale, causal, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, batch, s_len, t_len, heads,
                            kv_heads, scale, causal, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int rt_flash_attention(const void* q, const void* k, const void* v,
                                  void* out, int batch, int s_len, int t_len,
                                  int heads, int kv_heads, int d, float scale,
                                  int causal, int is_bf16, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_d<__nv_bfloat16>(d, q, k, v, out, batch, s_len, t_len,
                                        heads, kv_heads, scale, causal, s)
              : launch_d<float>(d, q, k, v, out, batch, s_len, t_len, heads,
                                kv_heads, scale, causal, s);
  return static_cast<int>(err);
}
