// Paged single-token decode attention with GQA, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ray_tpu/ops/paged_attention.py
// (_paged_kernel, reached through paged_attention).  It computes, for each
// lane b and query head, softmax(q . K[ctx]^T / sqrt(D)) . V[ctx] over the
// lane's first context_lens[b] positions, whose K/V rows live in flat
// per-layer slot pools [T, Hkv, D] at the physical pages block_tables[b, :].
//
// Design.  Pallas's sequential page grid dimension becomes a loop inside
// one thread block per (lane, kv head): the block reads the lane's context
// length and, per used page, the page id from the block table itself (no
// scalar prefetch here), and carries the online-softmax state (running
// max, denominator, accumulator) in fp32 for the G query heads that share
// the kv head.  The loop runs over tiles of up to 32 rows of a page (a
// whole page at the usual page sizes): each tile's K and V rows are copied
// straight from the flat pool into a ring of kStages shared-memory buffers
// with 16-byte cp.async copies issued kStages - 1 tiles ahead, so the
// copies of later tiles are in flight while the current one is scored.
// Scores use a warp per K row (lanes split D, a shuffle reduction per
// query head); the PV update gives each thread four consecutive output
// columns.  Rows at or past the context length are masked with -1e30,
// tiles past the last used row are never read, and a lane with ctx == 0
// writes zeros (the 1e-20 clamp on the denominator), never NaN.  Shared and
// copy-on-write pages need nothing special: pages are only addressed
// through the table.
//
// Bound.  Decode reads every used K/V byte once and does ~4 FLOPs per
// byte, so the kernel is bound by device-memory bytes (3.35 TB/s on an
// H100 SXM).  One block per (lane, kv head) gives B * Hkv blocks (64 at
// B = 8, Hkv = 8) on 132 SMs, and the longest lane sets the time: the
// card is under-filled, and splitting the page loop across blocks
// (split-K) is the known next step.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;    // K rows a warp scores together
constexpr int kHeads = 4;   // query heads a warp scores together
constexpr int kStages = 4;  // tiles in the shared-memory ring

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// N consecutive elements as floats (N * sizeof(T) is 4, 8 or 16 bytes).
template <typename T, int N>
__device__ __forceinline__ void load_floats(const T* p, float* out) {
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = rt::to_float(p[i]);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q,       // [B, H, D]
                    const T* __restrict__ pool_k,  // [num_slots, Hkv, D]
                    const T* __restrict__ pool_v,  // [num_slots, Hkv, D]
                    const int* __restrict__ block_tables,  // [B, W]
                    const int* __restrict__ context_lens,  // [B]
                    T* __restrict__ out,           // [B, H, D]
                    int hkv, int group, int width, int page_size,
                    int tile, float scale) {
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte copy
  constexpr int kLane = D / 32;         // score columns per lane
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tile_elems = tile * D;
  T* kv = reinterpret_cast<T*>(smem_raw);  // [kStages][2][tile][D]
  float* qs = reinterpret_cast<float*>(kv + kStages * 2 * tile_elems);
  float* ss = qs + group * D;           // [G][tile] scores, probabilities
  float* acc = ss + group * tile;       // [G][D]
  float* m = acc + group * D;           // [G] running max
  float* l = m + group;                 // [G] running denominator
  float* corr = l + group;              // [G] this tile's rescale factor

  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int ctx = context_lens[b];
  const int tiles_per_page = page_size / tile;
  const int used = max(0, min((ctx + tile - 1) / tile,
                              width * tiles_per_page));
  const int* table = block_tables + static_cast<size_t>(b) * width;
  const size_t head0 = (static_cast<size_t>(b) * hkv + kvh) * group;
  const size_t row_stride = static_cast<size_t>(hkv) * D;  // per slot

  // copy tile t's K and V rows into ring slot t % kStages
  auto issue = [&](int t) {
    T* dst = kv + (t % kStages) * 2 * tile_elems;
    const size_t slot0 =
        static_cast<size_t>(table[t / tiles_per_page]) * page_size +
        (t % tiles_per_page) * tile;
    const int vecs = tile_elems / kVec;
    for (int i = tid; i < 2 * vecs; i += kThreads) {
      const int side = i / vecs;  // 0 = K, 1 = V
      const int e = (i - side * vecs) * kVec;
      const int j = e / D;
      const int c = e - j * D;
      const T* src = (side ? pool_v : pool_k) + (slot0 + j) * row_stride +
                     static_cast<size_t>(kvh) * D + c;
      cp_async16(dst + side * tile_elems + e, src);
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < used) issue(s);
    cp_async_commit();
  }
  for (int i = tid; i < group * D; i += kThreads) {
    qs[i] = rt::to_float(q[head0 * D + i]);
    acc[i] = 0.f;
  }
  for (int g = tid; g < group; g += kThreads) {
    m[g] = rt::kNegInf;
    l[g] = 0.f;
  }

  for (int t = 0; t < used; ++t) {
    cp_async_wait<kStages - 2>();  // tile t has landed (this thread's part)
    __syncthreads();               // ... and everyone's; tile t-1 is done
    if (t + kStages - 1 < used) issue(t + kStages - 1);
    cp_async_commit();

    const T* ks = kv + (t % kStages) * 2 * tile_elems;
    const T* vs = ks + tile_elems;
    const int pos0 = t * tile;  // pages are contiguous in position
    // scores: a warp per K row, lanes split D.  kRows rows x kHeads heads
    // are reduced together so their shuffles are independent of each other
    for (int j0 = warp * kRows; j0 < tile; j0 += kWarps * kRows) {
      for (int g0 = 0; g0 < group; g0 += kHeads) {
        float dot[kRows][kHeads];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          float kf[kLane];
          if (j0 + r < tile) load_floats<T, kLane>(
              ks + (j0 + r) * D + lane * kLane, kf);
#pragma unroll
          for (int u = 0; u < kHeads; ++u) {
            dot[r][u] = 0.f;
            if (j0 + r < tile && g0 + u < group) {
              const float* qr = qs + (g0 + u) * D + lane * kLane;
#pragma unroll
              for (int i = 0; i < kLane; ++i)
                dot[r][u] = fmaf(qr[i], kf[i], dot[r][u]);
            }
          }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
#pragma unroll
          for (int r = 0; r < kRows; ++r)
#pragma unroll
            for (int u = 0; u < kHeads; ++u)
              dot[r][u] += __shfl_xor_sync(0xffffffffu, dot[r][u], off);
        if (lane == 0) {
#pragma unroll
          for (int r = 0; r < kRows; ++r)
#pragma unroll
            for (int u = 0; u < kHeads; ++u)
              if (j0 + r < tile && g0 + u < group)
                ss[(g0 + u) * tile + j0 + r] =
                    pos0 + j0 + r < ctx ? dot[r][u] * scale : rt::kNegInf;
        }
      }
    }
    __syncthreads();

    // online-softmax update: one warp per query head of the group
    for (int g = warp; g < group; g += kWarps) {
      float* sr = ss + g * tile;
      float mx = rt::kNegInf;
      for (int j = lane; j < tile; j += 32) mx = fmaxf(mx, sr[j]);
      mx = rt::group_max(mx);
      const float m_prev = m[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < tile; j += 32) {
        const float pj = pos0 + j < ctx ? expf(sr[j] - m_new) : 0.f;
        sr[j] = pj;
        sum += pj;
      }
      sum = rt::group_sum(sum);
      if (lane == 0) {
        const float c = expf(m_prev - m_new);
        corr[g] = c;
        l[g] = l[g] * c + sum;
        m[g] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V: four consecutive columns per thread
    for (int i = tid; i < group * (D / 4); i += kThreads) {
      const int g = i / (D / 4);
      const int c = (i - g * (D / 4)) * 4;
      const float* pr = ss + g * tile;
      float* ar = acc + g * D + c;
      const float cg = corr[g];
      float a[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) a[t] = ar[t] * cg;
#pragma unroll 4
      for (int j = 0; j < tile; ++j) {
        float vf[4];
        load_floats<T, 4>(vs + j * D + c, vf);
        const float pj = pr[j];
#pragma unroll
        for (int t = 0; t < 4; ++t) a[t] = fmaf(pj, vf[t], a[t]);
      }
#pragma unroll
      for (int t = 0; t < 4; ++t) ar[t] = a[t];
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  for (int i = tid; i < group * D; i += kThreads) {
    out[head0 * D + i] = rt::from_float<T>(acc[i] / fmaxf(l[i / D], 1e-20f));
  }
}

template <typename T, int D>
size_t smem_bytes(int group, int tile) {
  return sizeof(T) * kStages * 2 * tile * D +
         sizeof(float) * (2 * group * D + group * tile + 3 * group);
}

// Rows per pipelined tile: the largest divisor of page_size up to 32.
int tile_rows(int page_size) {
  int tile = page_size < 32 ? page_size : 32;
  while (page_size % tile) --tile;
  return tile;
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* pool_k, const void* pool_v,
                   const void* block_tables, const void* context_lens,
                   void* out, int batch, int hkv, int group, int width,
                   int page_size, float scale, cudaStream_t stream) {
  const int tile = tile_rows(page_size);
  // 128 KB of ring plus ~1.2 KB per query head at fp32, D = 128: a group
  // too large for shared memory fails here with cudaErrorInvalidValue.
  const size_t smem = smem_bytes<T, D>(group, tile);
  auto kernel = paged_decode_kernel<T, D>;
  cudaError_t err = rt::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(batch, hkv), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pool_k),
      static_cast<const T*>(pool_v), static_cast<const int*>(block_tables),
      static_cast<const int*>(context_lens), static_cast<T*>(out), hkv, group,
      width, page_size, tile, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int d, const void* q, const void* pool_k,
                     const void* pool_v, const void* block_tables,
                     const void* context_lens, void* out, int batch, int hkv,
                     int group, int width, int page_size, float scale,
                     cudaStream_t stream) {
  switch (d) {
    case 64:
      return launch<T, 64>(q, pool_k, pool_v, block_tables, context_lens,
                           out, batch, hkv, group, width, page_size, scale,
                           stream);
    case 128:
      return launch<T, 128>(q, pool_k, pool_v, block_tables, context_lens,
                            out, batch, hkv, group, width, page_size, scale,
                            stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int rt_paged_attention(const void* q, const void* pool_k,
                                  const void* pool_v, const void* block_tables,
                                  const void* context_lens, void* out,
                                  int batch, int hkv, int group, int d,
                                  int width, int page_size, float scale,
                                  int is_bf16, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_d<__nv_bfloat16>(d, q, pool_k, pool_v, block_tables,
                                        context_lens, out, batch, hkv, group,
                                        width, page_size, scale, s)
              : launch_d<float>(d, q, pool_k, pool_v, block_tables,
                                context_lens, out, batch, hkv, group, width,
                                page_size, scale, s);
  return static_cast<int>(err);
}
