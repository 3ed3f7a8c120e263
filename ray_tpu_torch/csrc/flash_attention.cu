// Flash attention forward with GQA and causal masking, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ray_tpu/ops/flash_attention.py
// (_flash_kernel, reached through _flash_forward and the flash_attention
// custom_vjp).  q [B, S, H, D], k/v [B, T, Hkv, D]; query head h reads kv
// head h / (H / Hkv).  The [S, T] score matrix never reaches device memory.
// Pallas's sequential kv grid dimension becomes a loop inside one block,
// which carries the online softmax (running max, denominator, output
// accumulator) in fp32 registers.  For causal attention the loop stops at
// the diagonal tile (the Pallas pl.when skip, now a loop bound), query
// tiles are scheduled heavy-first, and the finalize divides by the
// denominator clamped at 1e-20, as the reference does.
//
// Bound.  Causal prefill at S = 2048, H = 32, Hkv = 8 does ~800 FLOPs per
// byte of q/k/v/out, above the card's ~295 FLOPs/byte bf16 ridge: it is
// bound by operations, 989 TFLOP/s on the tensor cores.
//
// bf16: one warp-specialised block per (128-row query tile, head, batch),
// 288 threads.  Warp 8 is the producer: it gives up registers
// (setmaxnreg), loads the Q tile once and then streams 128-row K and V
// tiles of the block's kv head through a ring of kStages shared-memory
// stages with TMA, each stage guarded by a full and an empty mbarrier.
// Warps 0-3 and 4-7 are two consumer warpgroups, each owning 64 query
// rows.  Per kv tile a consumer computes S = Q K^T with wgmma m64n128k16
// (both operands K-major in shared memory, as the [B, T, Hkv, D] rows lie),
// runs the online softmax on the accumulator fragments in registers (a
// row's values sit in the four threads of a quad: two shfl.xor steps),
// rescales O, and adds P V with wgmma taking P from registers: the fp32
// fragment of S, rounded to bf16 pairs, has the layout of the A operand.
// V is the MN-major B operand (the transpose bit).  TMA writes the
// 128-byte swizzle and the descriptors describe that same layout
// (hopper.cuh); a D = 128 row is two 64-element boxes.  Rows past T and S
// arrive as zeros, so keys >= T are masked explicitly (a zero key scores
// 0, not -inf) and rows >= S are never stored; only tiles that cross the
// diagonal or T are masked.  P is rounded to bf16 on its way into the
// second product; the JAX kernel keeps it in fp32 (its error is bounded
// by p_rounding_allowance in ops/flash_attention.py).
//
// fp32: wgmma takes fp32 only as TF32 (~3 decimal digits), which would
// break the fp32 tolerance and the fp32 model parity, so fp32 keeps the
// first CUDA-core kernel: 64-row query tiles, K then V staged in shared
// memory, a 4 x 4 register tile of scores per thread, on the fp32 cores
// (67 TFLOP/s peak).
#include "common.cuh"
#include "hopper.cuh"

namespace {


// ------------------------------------------------- fp32: CUDA-core kernel

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // kv rows per tile
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 score patch each

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_simt_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ out,
                      int s_len, int t_len, int heads, int kv_heads,
                      float scale, int causal) {
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
  const float* qb = q + (static_cast<size_t>(b) * s_len + q0) * q_row +
                static_cast<size_t>(h) * D;
  const float* kb = k + static_cast<size_t>(b) * t_len * kv_row +
                static_cast<size_t>(kvh) * D;
  const float* vb = v + static_cast<size_t>(b) * t_len * kv_row +
                static_cast<size_t>(kvh) * D;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D;
    const int c = i - r * D;
    qs[r * DP + c] = qb[r * q_row + c];
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
      kv[r * DP + c] = kb[(t0 + r) * kv_row + c];
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
      kv[r * DP + c] = vb[(t0 + r) * kv_row + c];
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

  float* ob = out + (static_cast<size_t>(b) * s_len + q0) * q_row +
              static_cast<size_t>(h) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float inv = 1.f / fmaxf(l[i], 1e-20f);
#pragma unroll
    for (int j = 0; j < NC; ++j)
      ob[(ty * 4 + i) * q_row + tx + 16 * j] = acc[i][j] * inv;
  }
}

// ------------------------------------------- bf16: wgmma + TMA kernel

namespace wg {

namespace sm90 = rt::sm90;

constexpr int kBM = 128;                  // query rows per block
constexpr int kBN = 128;                  // kv rows per tile
constexpr int kThreads = 2 * 128 + 32;    // two consumer warpgroups + producer
constexpr int kProducerWarp = 8;
constexpr uint32_t kBox = 128 * 64 * 2;   // one TMA box: 128 rows x 128 bytes
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Cfg {
  static constexpr int kHalves = D / 64;          // 64-element boxes a row
  static constexpr uint32_t kTile = kHalves * kBox;  // a 128-row tile
  static constexpr int kStages = D == 64 ? 4 : 2;
  static constexpr uint32_t kBarriers = 8 * (1 + 2 * kStages);
  static constexpr size_t kSmem =
      1024 + kTile * (1 + 2 * kStages) + kBarriers;  // 1024: alignment slack
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map,
                       __nv_bfloat16* __restrict__ out, int s_len, int t_len,
                       int heads, int kv_heads, float scale_log2,
                       int causal) {
  using C = Cfg<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // 128-byte swizzle atoms must start 1024-byte aligned
  const uint32_t q_s = (sm90::smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t kv_s = q_s + C::kTile;  // stage s: K, then V
  const uint32_t q_full = kv_s + 2 * C::kStages * C::kTile;
  auto full = [&](int s) { return q_full + 8 + 8 * s; };
  auto empty = [&](int s) { return q_full + 8 + 8 * (C::kStages + s); };

  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;  // heavy
  const int h = blockIdx.y;                                 // tiles first
  const int b = blockIdx.z;
  const int kvh = h / (heads / kv_heads);
  const int q0 = qt * kBM;
  int n_tiles = (t_len + kBN - 1) / kBN;
  if (causal) n_tiles = min(n_tiles, (min(q0 + kBM, s_len) - 1) / kBN + 1);

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < C::kStages; ++s) {
      sm90::mbar_init(full(s), 1);   // the producer's arrive + TMA bytes
      sm90::mbar_init(empty(s), 2);  // one arrive per consumer warpgroup
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp == kProducerWarp) {
    // ---------------- producer: one lane issues every TMA load
    sm90::setmaxnreg_dec<40>();
    if (lane == 0) {
      sm90::mbar_arrive_expect_tx(q_full, C::kTile);
#pragma unroll
      for (int hf = 0; hf < C::kHalves; ++hf)
        sm90::tma_load_4d(q_s + hf * kBox, &q_map, q_full, hf * 64, h, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % C::kStages;
        sm90::mbar_wait(empty(s), ((i / C::kStages) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(full(s), 2 * C::kTile);
        const uint32_t k_dst = kv_s + 2 * s * C::kTile;
#pragma unroll
        for (int hf = 0; hf < C::kHalves; ++hf) {
          sm90::tma_load_4d(k_dst + hf * kBox, &k_map, full(s), hf * 64, kvh,
                            i * kBN, b);
          sm90::tma_load_4d(k_dst + C::kTile + hf * kBox, &v_map, full(s),
                            hf * 64, kvh, i * kBN, b);
        }
      }
    }
  } else {
    // ---------------- consumers: 64 query rows per warpgroup
    const int wgi = warp / 4;              // consumer warpgroup
    const int wq = warp % 4;               // warp within it: 16 rows each
    const int row0 = q0 + wgi * 64 + wq * 16 + lane / 4;  // and row0 + 8
    const int cq = 2 * (lane % 4);         // column pair within 8 columns
    const uint32_t q_wg = q_s + wgi * 64 * 128;  // this warpgroup's rows

    float o[D / 2];
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};               // this thread's part of the sum
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;

    sm90::mbar_wait(q_full, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % C::kStages;
      const int t0 = i * kBN;
      const uint32_t k_base = kv_s + 2 * s * C::kTile;
      const uint32_t v_base = k_base + C::kTile;
      sm90::mbar_wait(full(s), (i / C::kStages) & 1);

      // S = Q K^T: D / 16 steps of 16 along the head dimension
      float sc[64];
#pragma unroll
      for (int j = 0; j < 64; ++j) sc[j] = 0.f;
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk / 4) * kBox + (kk % 4) * 32;
        sm90::wgmma_ss_n128(sc, sm90::desc_sw128(q_wg + off, 16, 1024),
                            sm90::desc_sw128(k_base + off, 16, 1024), kk > 0);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
#pragma unroll
      for (int j = 0; j < 64; ++j) sm90::reg_fence(sc[j]);

      // fragment element 4j + e: row row0 + 8 * (e / 2),
      // key t0 + 8j + cq + e % 2
      const bool edge = t0 + kBN > t_len ||
                        (causal && t0 + kBN - 1 > q0 + wgi * 64 + wq * 16);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[4 * j + e] * scale_log2;
          if (edge) {
            const int key = t0 + 8 * j + cq + (e & 1);
            const int row = row0 + 8 * (e >> 1);
            if (key >= t_len || (causal && key > row)) x = -INFINITY;
          }
          sc[4 * j + e] = x;
        }
      }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < 16; ++j)
          mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[r], mx);
        const float m_use = m_new == -INFINITY ? 0.f : m_new;  // all masked
        corr[r] = exp2f(m[r] - m_use);
        m[r] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float p = exp2f(sc[4 * j + 2 * r + c] - m_use);
            sc[4 * j + 2 * r + c] = p;
            sum += p;
          }
        }
        l[r] = l[r] * corr[r] + sum;
      }
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j + 0] *= corr[0];
        o[4 * j + 1] *= corr[0];
        o[4 * j + 2] *= corr[1];
        o[4 * j + 3] *= corr[1];
      }

      // O += P V: P as bf16 A fragments, 16 keys a step
      uint32_t pa[8][4];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
        for (int x = 0; x < 4; ++x)
          pa[kk][x] = sm90::pack_bf16(sc[8 * kk + 2 * x],
                                      sc[8 * kk + 2 * x + 1]);
      }
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const uint64_t dv = sm90::desc_sw128(v_base + kk * 16 * 128, kBox,
                                             1024);
        if constexpr (D == 128)
          sm90::wgmma_rs_n128(o, pa[kk], dv);
        else
          sm90::wgmma_rs_n64(o, pa[kk], dv);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
#pragma unroll
      for (int j = 0; j < D / 2; ++j) sm90::reg_fence(o[j]);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
#pragma unroll
        for (int x = 0; x < 4; ++x) sm90::reg_fence(pa[kk][x]);
      if (threadIdx.x % 128 == 0) sm90::mbar_arrive(empty(s));
    }

    // finalize: rows >= S are padding and never stored
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sum = l[r];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float inv = 1.f / fmaxf(sum, 1e-20f);
      const int row = row0 + 8 * r;
      if (row >= s_len) continue;
      uint32_t* orow = reinterpret_cast<uint32_t*>(
          out + ((static_cast<size_t>(b) * s_len + row) * heads + h) * D);
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        orow[(8 * j + cq) / 2] = sm90::pack_bf16(o[4 * j + 2 * r] * inv,
                                                 o[4 * j + 2 * r + 1] * inv);
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int batch, int s_len, int t_len, int heads, int kv_heads,
                   float scale, int causal, cudaStream_t stream) {
  CUtensorMap q_map, k_map, v_map;
  cudaError_t err = sm90::make_map_bf16_4d(&q_map, q, D, heads, s_len,
                                           batch, kBM);
  if (err == cudaSuccess)
    err = sm90::make_map_bf16_4d(&k_map, k, D, kv_heads, t_len, batch, kBN);
  if (err == cudaSuccess)
    err = sm90::make_map_bf16_4d(&v_map, v, D, kv_heads, t_len, batch, kBN);
  if (err != cudaSuccess) return err;
  const size_t smem = Cfg<D>::kSmem;
  err = rt::allow_smem(flash_fwd_wgmma_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((s_len + kBM - 1) / kBM, heads, batch);
  flash_fwd_wgmma_kernel<D><<<grid, kThreads, smem, stream>>>(
      q_map, k_map, v_map, static_cast<__nv_bfloat16*>(out), s_len, t_len,
      heads, kv_heads, scale * kLog2e, causal);
  return cudaGetLastError();
}

}  // namespace wg

template <int D>
cudaError_t launch_simt(const void* q, const void* k, const void* v,
                        void* out, int batch, int s_len, int t_len,
                        int heads, int kv_heads, float scale, int causal,
                        cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((kBQ + kBK) * (D + 1) + kBQ * (kBK + 1));
  cudaError_t err = rt::allow_smem(flash_fwd_simt_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(s_len / kBQ, heads, batch);
  flash_fwd_simt_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), s_len, t_len,
      heads, kv_heads, scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* out,
                     int batch, int s_len, int t_len, int heads, int kv_heads,
                     float scale, int causal, int is_bf16,
                     cudaStream_t stream) {
  return is_bf16 ? wg::launch<D>(q, k, v, out, batch, s_len, t_len, heads,
                                 kv_heads, scale, causal, stream)
                 : launch_simt<D>(q, k, v, out, batch, s_len, t_len, heads,
                                  kv_heads, scale, causal, stream);
}

}  // namespace

extern "C" int rt_flash_attention(const void* q, const void* k, const void* v,
                                  void* out, int batch, int s_len, int t_len,
                                  int heads, int kv_heads, int d, float scale,
                                  int causal, int is_bf16, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (d) {
    case 64:
      err = launch_d<64>(q, k, v, out, batch, s_len, t_len, heads, kv_heads,
                         scale, causal, is_bf16, s);
      break;
    case 128:
      err = launch_d<128>(q, k, v, out, batch, s_len, t_len, heads, kv_heads,
                          scale, causal, is_bf16, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
