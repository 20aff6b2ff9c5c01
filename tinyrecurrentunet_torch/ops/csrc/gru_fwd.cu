// Forward GRU recurrence over a precomputed input projection, for Hopper
// (sm_90a). Built with nvcc into a shared library with a plain C interface
// and called through ctypes (tinyrecurrentunet_torch/ops/cuda_gru.py).
//
// Replaces the TPU kernel `_gru_kernel` of tinyrecurrentunet_tpu/ops/
// pallas_gru.py (wrapper `gru_scan_pallas`) and, with its residuals saved
// (the resident kernel's SAVE instantiations), `_fwd_kernel` of
// tinyrecurrentunet_tpu/ops/pallas_gru_vjp.py at H = 64, 128, 256, 512; at
// any other H the training forward is gru_fwd_train_kernel of gru_train.cu.
// Per step, for every row:
//   hp = h @ Wh + bh;  r = sigmoid(xr + hr);  z = sigmoid(xz + hz);
//   n = tanh(xn + r * hn);  h = (1 - z) * n + z * h
// Gate order r, z, n as torch.nn.GRU; bh sits inside r * hn.
//
// Layouts (all float32, contiguous):
//   x_proj (rows, T, 3H)   out (rows, T, H)   h0, hT (rows, H)
//   Wh (H, 3H)             bh (3H)
// `reverse` walks time from T-1 down to 0 inside the kernel; outputs stay at
// their input positions and hT is the carry after the last step walked. The
// loop over time runs inside the block, so there is no padding of T.
//
// What bounds it on this card: not bytes or FLOPs (a flagship call moves a
// few MB and does ~0.1 GFLOP) but the serial chain of T dependent small
// products, one step's h @ Wh needing the previous step's h. The only lever
// is the latency of one step, and Wh never changes during a call.
//
// Design: two kernels, chosen by the wrapper's `fwd_plan(rows, T, H, SMs)`.
//
// gru_fwd_resident_kernel<H, CS, C, KS, R> (paths "registers", CS = 1, and
// "cluster", CS = 8 or 16; H = 64, 128, 256, 512). Wh stays in registers for
// the whole call. A row tile of R rows belongs to CS blocks; block `rank`
// owns the hidden units [rank * H/CS, (rank + 1) * H/CS) and their three gate
// columns. A group of KS neighbouring lanes owns C gate columns: lane ks
// holds the words of those columns for the k with (k / 4) % KS == ks,
// C * H / KS registers (64 at H = 64, else 128), loaded once. Per step a lane
// reads h as float4 words from shared memory (the lanes of a group read
// neighbouring words, the groups of a warp the same ones) and feeds each word
// to C FMA chains. A warp-wide 16-byte shared load returns 512 bytes at 128
// bytes a cycle whatever is broadcast, so with one column per lane group the
// loads, not the FMAs, bound the step; C columns per group cut them C times.
// The KS partial sums of a column meet by __shfl_xor_sync: butterflies down
// to C lanes, then a transposing reduction (C - 1 shuffles) that leaves one
// finished column with each of the first C lanes. That lane leaves its
// pre-activation (with bh) and its x_proj word in shared memory; after one
// __syncthreads() the gates of the block's units are applied, once each, and
// the new h is stored into the h buffer of every block of the cluster
// (distributed shared memory, cluster.map_shared_rank; a warp stores 32
// consecutive words per destination). h is double-buffered, so one
// cluster.sync() (CS = 1: __syncthreads()) a step is enough: a block that
// runs ahead writes the buffer its peers have finished reading. The next
// step's x_proj words are loaded before the product. The gates run on the
// special-function unit (__expf, __fdividef; ~1e-7 absolute): they are a
// third of the serial chain of one step.
//   H = 64: one block of 192 threads per row tile (C 2, KS 2).
//   H = 128: one block of 384 threads (C 4, KS 4).
//   H = 256: clusters of 8 blocks of 192 threads, 32 units each (C 4, KS 8).
//   H = 512: clusters of 16 blocks (non-portable size) of 384 threads, 32
//   units each (C 4, KS 16); a block's slice of the 3 MB Wh is 48k words.
// A cluster that cannot be scheduled is an error (the wrapper asks
// cudaOccupancyMaxActiveClusters once per device and raises on 0; the launch
// itself fails otherwise), never a change of path.
//
// SAVE (the training forward, `trunet_gru_fwd_train_resident`, chosen by
// `fwd_train_plan` in cuda_gru.py): the gate loop also writes r, z, n and hn
// (the pre-activation h @ Wh_n + bh_n, as gsm holds it) of each (row, unit)
// into saved[row, t, 0:4H], beside out: 4H more floats a row and step, each
// store coalesced over the units. At CS = 1 its blocks stay on the card
// (grid: the blocks the card holds at once) and walk row tile after row
// tile, so Wh is loaded into registers once a block, not once a tile (the
// flagship's FGRU has 16,064 rows of 16 steps). At CS > 1 it keeps one
// cluster per tile. The step's x_proj words come through a ring of 4 stages
// of shared memory that each owner lane fills 3 steps ahead with 4-byte
// cp.async copies (one commit group a step, waited for before the gates'
// barrier), across tile boundaries; walking blocks take each tile's h0
// through the same ring, so neither load stands in the serial chain, and
// no register holds them in flight (H = 128 spilled 8 bytes at 2 and 4 rows
// with them in registers). At H = 64 a lane group owns 4 columns (KS = 4),
// not 2: over many rows the step is bound by its shared loads, and one
// float4 of h then feeds 16 FMAs. SAVE = false is the inference kernel, one
// block or cluster per tile, as before.
//
// gru_fwd_kernel<RPT, WH_SMEM> (path "general", any 1 <= H <= 1024). One
// block owns RPT rows, thread j owns hidden unit j and computes the three
// gate columns j, H+j, 2H+j out of Wh in shared memory when it fits (H <=
// 128) and out of global memory (L2) otherwise; h double-buffered, one
// barrier a step.
//
// Registers a thread and static shared memory a block, as `nvcc -Xptxas -v`
// reports them for sm_90a (CUDA 12.8), by rows per tile:
//   H = 64  (192 threads): 94 / 94 / 129 / 163 registers at 1 / 2 / 4 / 8
//           rows; 2 / 4 / 8 / 16 KB.
//   H = 128 (384 threads): 166 / 168 / 168 at 1 / 2 / 4 rows (4 bytes spilled
//           at 4); 4 / 8 / 16 KB.
//   H = 256 (192 threads): 164 / 168 / 197 / 255 at 1 / 2 / 4 / 8 rows, no
//           spill; 2.8 / 5.6 / 11 / 22 KB.
//   H = 512 (384 threads): 165 / 168 / 168 / 168 at 1 / 2 / 3 / 4 rows (8
//           bytes spilled at 4); 4.9 / 9.7 / 14.6 / 19.5 KB.
//   general kernel: 32-168 registers; dynamic shared memory 8 * RPT * H bytes
//           plus 12 * H * H for Wh when that fits (H <= 128).
// With SAVE (the training forward, 4-stage x_proj ring; H = 64 as C 4, KS 4):
//   H = 64  (192 threads): 110 / 96 / 135 / 167 registers at 1 / 2 / 4 / 8
//           rows, no spill; 5.3 / 10.5 / 21 / 42 KB (two blocks an SM at 4
//           and 8 rows).
//   H = 128 (384 threads): 168 / 168 / 168 at 1 / 2 / 4 rows, no spill;
//           10.5 / 21 / 42 KB.
//   H = 256: 162 / 167 / 168 / 255 at 1 / 2 / 4 / 8 rows, no spill; 3.9 /
//           7.8 / 15.5 / 31 KB.
//   H = 512: 166 / 167 / 168 / 168 at 1 / 2 / 3 / 4 rows, no spill; 5.9 /
//           11.8 / 17.6 / 23.5 KB.
// The Wh slice of a thread (64 words at H = 64, else 128) stays in registers
// in every instantiation.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

__device__ __forceinline__ float sigmoid_f(float x) { return 1.0f / (1.0f + expf(-x)); }

// The gates on the special-function unit (ex2.approx, rcp.approx): ~1e-7
// absolute, a third of the dependent instructions of expf and tanhf.
__device__ __forceinline__ float sigmoid_fast(float x) {
  return __fdividef(1.0f, 1.0f + __expf(-x));
}
__device__ __forceinline__ float tanh_fast(float x) {
  const float e = __expf(-2.0f * fabsf(x));
  return copysignf(__fdividef(1.0f - e, 1.0f + e), x);
}

template <int RPT, bool WH_SMEM>
__global__ void gru_fwd_kernel(const float* __restrict__ xp, const float* __restrict__ h0,
                               const float* __restrict__ wh, const float* __restrict__ bh,
                               float* __restrict__ out, float* __restrict__ h_last, int rows,
                               int T, int H, int reverse) {
  extern __shared__ float smem[];
  const int G = 3 * H;
  float* hbuf = smem;               // [2][RPT][H]
  float* wsm = smem + 2 * RPT * H;  // [H][3H] when WH_SMEM
  const int j = threadIdx.x;
  const int row0 = blockIdx.x * RPT;

  if (WH_SMEM) {
    for (int i = j; i < H * G; i += blockDim.x) wsm[i] = wh[i];
  }
  const float* W = WH_SMEM ? wsm : wh;
  const float br = bh[j];
  const float bz = bh[H + j];
  const float bn = bh[2 * H + j];

  bool valid[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    valid[r] = row0 + r < rows;
    hbuf[r * H + j] = valid[r] ? h0[(size_t)(row0 + r) * H + j] : 0.0f;
  }

  // inputs of the first step walked
  float xr[RPT], xz[RPT], xn[RPT];
  {
    const int t = reverse ? T - 1 : 0;
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      xr[r] = xz[r] = xn[r] = 0.0f;
      if (valid[r] && T > 0) {
        const float* x = xp + ((size_t)(row0 + r) * T + t) * G;
        xr[r] = x[j];
        xz[r] = x[H + j];
        xn[r] = x[2 * H + j];
      }
    }
  }
  __syncthreads();

  for (int s = 0; s < T; ++s) {
    const int t = reverse ? T - 1 - s : s;
    const float* hc = hbuf + (s & 1) * RPT * H;
    float* hn = hbuf + ((s + 1) & 1) * RPT * H;

    // prefetch the next step's inputs
    float nxr[RPT], nxz[RPT], nxn[RPT];
    const int tn = reverse ? t - 1 : t + 1;
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      nxr[r] = nxz[r] = nxn[r] = 0.0f;
      if (valid[r] && s + 1 < T) {
        const float* x = xp + ((size_t)(row0 + r) * T + tn) * G;
        nxr[r] = x[j];
        nxz[r] = x[H + j];
        nxn[r] = x[2 * H + j];
      }
    }

    float ar[RPT], az[RPT], an[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) ar[r] = az[r] = an[r] = 0.0f;
#pragma unroll 4
    for (int k = 0; k < H; ++k) {
      const float* wk = W + (size_t)k * G;
      const float wr = wk[j];
      const float wz = wk[H + j];
      const float wn = wk[2 * H + j];
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const float hk = hc[r * H + k];
        ar[r] = fmaf(hk, wr, ar[r]);
        az[r] = fmaf(hk, wz, az[r]);
        an[r] = fmaf(hk, wn, an[r]);
      }
    }

#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const float rg = sigmoid_f(xr[r] + (ar[r] + br));
      const float zg = sigmoid_f(xz[r] + (az[r] + bz));
      const float ng = tanhf(xn[r] + rg * (an[r] + bn));
      const float h = (1.0f - zg) * ng + zg * hc[r * H + j];
      hn[r * H + j] = h;
      if (valid[r]) out[((size_t)(row0 + r) * T + t) * H + j] = h;
      xr[r] = nxr[r];
      xz[r] = nxz[r];
      xn[r] = nxn[r];
    }
    __syncthreads();
  }

  const float* hl = hbuf + (T & 1) * RPT * H;
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    if (valid[r]) h_last[(size_t)(row0 + r) * H + j] = hl[r * H + j];
  }
}

// ---------------------------------------------------- Wh resident in registers

namespace cg = cooperative_groups;

// 4-byte asynchronous copy global -> shared (no registers held while in flight).
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// waits until at most N of this thread's newest copy groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int H, int CS, int C, int KS, int R, bool SAVE>
__global__ void __launch_bounds__(3 * (H / CS) / C * KS)
    gru_fwd_resident_kernel(const float* __restrict__ xp, const float* __restrict__ h0,
                            const float* __restrict__ wh, const float* __restrict__ bh,
                            float* __restrict__ out, float* __restrict__ h_last,
                            float* __restrict__ saved, int rows, int T, int reverse) {
  // blocks that stay on the card and walk row tile after row tile
  constexpr bool WALK = SAVE && CS == 1;
  constexpr int HS = H / CS;          // hidden units of this block
  constexpr int LC = 3 * HS;          // its gate columns
  constexpr int NT = LC / C * KS;     // threads: KS lanes for every C columns
  constexpr int G = 3 * H;
  constexpr int KI = H / (4 * KS);    // float4 words of h a lane reads per row
  constexpr int NP = R * C >= 8 ? 1 : 2;  // independent FMA chains per row and column
  constexpr int GATES = R * HS;            // gate evaluations a step
  constexpr int GE = (GATES + NT - 1) / NT;
  // SAVE: x_proj (and, walking, the next tiles' h0) arrive through a ring of
  // NS stages of shared memory, copied AHEAD steps ahead by cp.async
  constexpr int NS = SAVE ? 4 : 1;
  constexpr int AHEAD = NS - 1;
  constexpr int STAGE = R * LC + (WALK ? R * H : 0);
  static_assert(H % (4 * KS) == 0 && H % CS == 0 && HS % C == 0 && KS % C == 0 &&
                    32 % KS == 0 && NT % 32 == 0, "shape");

  __shared__ __align__(16) float hbuf[2 * R * H];  // h of the tile, double-buffered
  __shared__ float gsm[R * LC];                    // h @ Wh + bh, this block's columns
  __shared__ float xsm[NS * STAGE];                // x_proj of the step, the same columns

  const int tid = threadIdx.x;
  const int ks = tid % KS;
  const int lc0 = (tid / KS) * C;  // first local column of the lane group
  int rank = 0;
  if constexpr (CS > 1) rank = (int)cg::this_cluster().block_rank();
  const int tiles = (rows + R - 1) / R;

  if constexpr (SAVE) {
    if (T == 0) {  // no step: h_T = h0
      for (int tile = blockIdx.x / CS; tile < tiles; tile += gridDim.x / CS) {
        for (int e = tid; e < R * HS; e += NT) {
          const int row = tile * R + e / HS;
          const int j = rank * HS + e % HS;
          if (row < rows) h_last[(size_t)row * H + j] = h0[(size_t)row * H + j];
        }
      }
      return;
    }
  }

  // local column lc = gate * HS + unit  <->  column gate * H + rank * HS + unit of Wh
  const int gcol0 = (lc0 / HS) * H + rank * HS + lc0 % HS;

  // w[c][4 i + q] = Wh[(i * KS + ks) * 4 + q, gcol0 + c]
  float w[C][4 * KI];
#pragma unroll
  for (int i = 0; i < KI; ++i) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float* src = wh + (size_t)((i * KS + ks) * 4 + q) * G + gcol0;
#pragma unroll
      for (int c = 0; c < C; ++c) w[c][4 * i + q] = src[c];
    }
  }
  // after the reduction lane ks < C holds column lc0 + ks
  const bool owner = ks < C;
  const int lc = lc0 + ks % C;
  const int gcol = gcol0 + ks % C;
  const float bias = bh[gcol];

  // SAVE: the ring's next position, (tile, step), and its count; q counts
  // the positions walked
  int pf_tile = blockIdx.x / CS, pf_s = 0, pf_q = 0, q = 0;
  // copies the x_proj words of the owner's column at the ring's next
  // position (and, walking, at a tile's first step its h0), one commit
  // group a position
  const auto fetch = [&]() {
    if (pf_tile < tiles) {
      float* st = xsm + (pf_q % NS) * STAGE;
      const int prow0 = pf_tile * R;
      const int pt = reverse ? T - 1 - pf_s : pf_s;
      if (owner) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (prow0 + r < rows)
            cp_async4(st + r * LC + lc, xp + ((size_t)(prow0 + r) * T + pt) * G + gcol);
          else
            st[r * LC + lc] = 0.0f;
        }
      }
      if constexpr (WALK) {
        if (pf_s == 0) {
          for (int e = tid; e < R * H; e += NT) {
            const int row = prow0 + e / H;
            if (row < rows)
              cp_async4(st + R * LC + e, h0 + (size_t)row * H + e % H);
            else
              st[R * LC + e] = 0.0f;
          }
        }
      }
      if (++pf_s == T) {
        pf_s = 0;
        pf_tile += gridDim.x / CS;
      }
    }
    ++pf_q;
    cp_async_commit();
  };
  if constexpr (SAVE) {
#pragma unroll
    for (int i = 0; i < AHEAD; ++i) fetch();
  }

  int tile = blockIdx.x / CS;
  do {
    const int row0 = tile * R;
    if constexpr (WALK) {
      // this tile's h0 came with the ring position of its first step; each
      // thread reads back what it copied
      cp_async_wait<AHEAD - 1>();
      const float* h0s = xsm + (q % NS) * STAGE + R * LC;
      for (int e = tid; e < R * H; e += NT) hbuf[e] = h0s[e];
    } else {
      for (int e = tid; e < R * H; e += NT) {
        const int r = e / H;
        hbuf[e] = row0 + r < rows ? h0[(size_t)(row0 + r) * H + (e - r * H)] : 0.0f;
      }
    }

    // x_proj words of the first step walked (SAVE: the ring)
    float x[SAVE ? 1 : R];
    if constexpr (!SAVE) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        x[r] = 0.0f;
        if (owner && row0 + r < rows && T > 0)
          x[r] = xp[((size_t)(row0 + r) * T + (reverse ? T - 1 : 0)) * G + gcol];
      }
    }
    if constexpr (CS > 1) cg::this_cluster().sync(); else __syncthreads();

    for (int s = 0; s < T; ++s) {
      const int t = reverse ? T - 1 - s : s;
      const float* hc = hbuf + (s & 1) * R * H;
      const int nxt = ((s + 1) & 1) * R * H;

      // prefetch the next step's inputs (SAVE: the ring's position AHEAD steps on)
      float nx[SAVE ? 1 : R];
      if constexpr (SAVE) {
        fetch();
      } else {
        const int tn = reverse ? t - 1 : t + 1;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          nx[r] = 0.0f;
          if (owner && row0 + r < rows && s + 1 < T)
            nx[r] = xp[((size_t)(row0 + r) * T + tn) * G + gcol];
        }
      }

      float acc[R][C];
      {
        float part[R][C][NP];
#pragma unroll
        for (int r = 0; r < R; ++r) {
#pragma unroll
          for (int c = 0; c < C; ++c) {
#pragma unroll
            for (int p = 0; p < NP; ++p) part[r][c][p] = 0.0f;
          }
        }
        const float4* h4 = reinterpret_cast<const float4*>(hc);
#pragma unroll
        for (int i = 0; i < KI; ++i) {
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float4 hv = h4[r * (H / 4) + i * KS + ks];
#pragma unroll
            for (int c = 0; c < C; ++c) {
              part[r][c][0] = fmaf(hv.x, w[c][4 * i + 0], part[r][c][0]);
              part[r][c][NP - 1] = fmaf(hv.y, w[c][4 * i + 1], part[r][c][NP - 1]);
              part[r][c][0] = fmaf(hv.z, w[c][4 * i + 2], part[r][c][0]);
              part[r][c][NP - 1] = fmaf(hv.w, w[c][4 * i + 3], part[r][c][NP - 1]);
            }
          }
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
#pragma unroll
          for (int c = 0; c < C; ++c) {
            acc[r][c] = part[r][c][0];
            if constexpr (NP == 2) acc[r][c] += part[r][c][NP - 1];
          }
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        // sum over the KS lanes: plain butterflies down to C lanes, then a
        // transposing reduction that leaves column lc0 + ks % C with lane ks
#pragma unroll
        for (int o = KS / 2; o >= C; o >>= 1) {
#pragma unroll
          for (int c = 0; c < C; ++c) acc[r][c] += __shfl_xor_sync(0xffffffffu, acc[r][c], o);
        }
#pragma unroll
        for (int o = C / 2; o >= 1; o >>= 1) {
          const bool up = (ks & o) != 0;
#pragma unroll
          for (int j = 0; j < o; ++j) {
            const float send = up ? acc[r][j] : acc[r][j + o];
            const float keep = up ? acc[r][j + o] : acc[r][j];
            acc[r][j] = keep + __shfl_xor_sync(0xffffffffu, send, o);
          }
        }
        if (owner) {
          gsm[r * LC + lc] = acc[r][0] + bias;
          if constexpr (!SAVE) xsm[r * LC + lc] = x[r];
        }
        if constexpr (!SAVE) x[r] = nx[r];
      }
      if constexpr (SAVE) cp_async_wait<AHEAD>();  // this step's x_proj has landed
      __syncthreads();

      // gates of this block's units; the new h goes to every block of the cluster
      const float* xstep = xsm + (SAVE ? (q % NS) * STAGE : 0);
#pragma unroll
      for (int it = 0; it < GE; ++it) {
        const int e = tid + it * NT;
        if (e < GATES) {
          const int r = e / HS;
          const int u = e - r * HS;
          const float* g = gsm + r * LC;
          const float* xs = xstep + r * LC;
          const float rg = sigmoid_fast(xs[u] + g[u]);
          const float zg = sigmoid_fast(xs[HS + u] + g[HS + u]);
          const float ng = tanh_fast(xs[2 * HS + u] + rg * g[2 * HS + u]);
          const int j = rank * HS + u;
          const float h = (1.0f - zg) * ng + zg * hc[r * H + j];
          if constexpr (CS > 1) {
#pragma unroll
            for (int dst = 0; dst < CS; ++dst)
              cg::this_cluster().map_shared_rank(hbuf, dst)[nxt + r * H + j] = h;
          } else {
            hbuf[nxt + r * H + j] = h;
          }
          if (row0 + r < rows) {
            const size_t rt = (size_t)(row0 + r) * T + t;
            out[rt * H + j] = h;
            if constexpr (SAVE) {
              float* sv = saved + rt * 4 * H;
              sv[j] = rg;
              sv[H + j] = zg;
              sv[2 * H + j] = ng;
              sv[3 * H + j] = g[2 * HS + u];  // hn: h @ Wh_n + bh_n
            }
          }
        }
      }
      if constexpr (SAVE) ++q;
      if constexpr (CS > 1) cg::this_cluster().sync(); else __syncthreads();
    }

    const float* hl = hbuf + (T & 1) * R * H;
    for (int e = tid; e < R * HS; e += NT) {
      const int r = e / HS;
      const int j = rank * HS + (e - r * HS);
      if (row0 + r < rows) h_last[(size_t)(row0 + r) * H + j] = hl[r * H + j];
    }
    if constexpr (WALK) __syncthreads();  // the next tile rewrites hbuf and gsm
    tile += gridDim.x / CS;
  } while (WALK && tile < tiles);
}

// ------------------------------------------------------------ launching

struct Args {
  const float *xp, *h0, *wh, *bh;
  float *out, *h_last;
  float* saved;  // the residuals of the training forward; null for inference
  int rows, T, H, reverse;
};

size_t smem_bytes(int H, int rpt, bool wh_smem) {
  return (size_t)(2 * rpt * H + (wh_smem ? 3 * H * H : 0)) * sizeof(float);
}

int max_optin_smem() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
      cudaSuccess)
    return 0;
  return bytes;
}

template <int RPT, bool WH_SMEM>
cudaError_t launch_general(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.H, RPT, WH_SMEM);
  auto kernel = gru_fwd_kernel<RPT, WH_SMEM>;
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((a.rows + RPT - 1) / RPT);
  kernel<<<grid, a.H, smem, stream>>>(a.xp, a.h0, a.wh, a.bh, a.out, a.h_last, a.rows, a.T,
                                      a.H, a.reverse);
  return cudaGetLastError();
}

template <bool WH_SMEM>
cudaError_t dispatch_general(int rpt, const Args& a, cudaStream_t stream) {
  switch (rpt) {
    case 1: return launch_general<1, WH_SMEM>(a, stream);
    case 2: return launch_general<2, WH_SMEM>(a, stream);
    case 4: return launch_general<4, WH_SMEM>(a, stream);
    case 8: return launch_general<8, WH_SMEM>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The launch of the resident kernel over `tiles` row tiles: one cluster of
// CS blocks per tile (CS = 1: plain blocks). `attr` must outlive `cfg`.
template <int CS>
void resident_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr, int threads, int tiles,
                     cudaStream_t stream) {
  cfg = {};
  cfg.gridDim = dim3((unsigned)tiles * CS);
  cfg.blockDim = dim3(threads);
  cfg.stream = stream;
  if (CS > 1) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = CS;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
}

// Allows the kernel its cluster size on the current device where that is
// above the portable 8, and reports the clusters the device holds at once.
template <int H, int CS, int C, int KS, int R, bool SAVE>
cudaError_t resident_prepare(int* clusters) {
  auto kernel = gru_fwd_resident_kernel<H, CS, C, KS, R, SAVE>;
  if (CS > 8) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  resident_config<CS>(cfg, attr, 3 * (H / CS) / C * KS, 64, nullptr);
  return cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
}

// One block (cluster) per row tile; with SAVE at CS = 1 only as many blocks
// as the card holds at once, each walking several tiles. A cluster that the
// card cannot hold, or a cluster size that trunet_gru_fwd_max_clusters has
// not allowed on this device, is an error of the launch, not a change of path.
template <int H, int CS, int C, int KS, int R, bool SAVE>
cudaError_t launch_resident(const Args& a, cudaStream_t stream) {
  auto kernel = gru_fwd_resident_kernel<H, CS, C, KS, R, SAVE>;
  constexpr int threads = 3 * (H / CS) / C * KS;
  int groups = (a.rows + R - 1) / R;
  cudaError_t err;
  if constexpr (SAVE && CS == 1) {
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0)) !=
        cudaSuccess)
      return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    if (groups > per_sm * sms) groups = per_sm * sms;
  }
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  resident_config<CS>(cfg, attr, threads, groups, stream);
  err = cudaLaunchKernelEx(&cfg, kernel, a.xp, a.h0, a.wh, a.bh, a.out, a.h_last, a.saved,
                           a.rows, a.T, a.reverse);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

#define TRUNET_RESIDENT(HH, CS, C, KS, RR) \
  if (a.H == HH && rows_per_tile == RR) return launch_resident<HH, CS, C, KS, RR, SAVE>(a, stream);

// The instantiations of the resident kernel, (H, blocks of a cluster, columns
// and lanes of a lane group, rows per tile), each built for inference and
// (SAVE) for training; any other is refused. Per H the (columns, lanes) are
// the fastest of those measured on an H100 (scripts/torch_gru_kernel_profile.py,
// PERF.md).
template <bool SAVE>
cudaError_t dispatch_resident(int rows_per_tile, const Args& a, cudaStream_t stream) {
  // at H = 64 the training forward's lane group owns four columns, not two:
  // over many rows its step is bound by the shared loads, which this halves
  constexpr int C64 = SAVE ? 4 : 2;
  TRUNET_RESIDENT(64, 1, C64, C64, 1) TRUNET_RESIDENT(64, 1, C64, C64, 2)
  TRUNET_RESIDENT(64, 1, C64, C64, 4) TRUNET_RESIDENT(64, 1, C64, C64, 8)
  TRUNET_RESIDENT(128, 1, 4, 4, 1) TRUNET_RESIDENT(128, 1, 4, 4, 2)
  TRUNET_RESIDENT(128, 1, 4, 4, 4)
  TRUNET_RESIDENT(256, 8, 4, 8, 1) TRUNET_RESIDENT(256, 8, 4, 8, 2)
  TRUNET_RESIDENT(256, 8, 4, 8, 4) TRUNET_RESIDENT(256, 8, 4, 8, 8)
  TRUNET_RESIDENT(512, 16, 4, 16, 1) TRUNET_RESIDENT(512, 16, 4, 16, 2)
  TRUNET_RESIDENT(512, 16, 4, 16, 3) TRUNET_RESIDENT(512, 16, 4, 16, 4)
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Launches the recurrence on `stream`; returns the cudaError_t of the launch.
// resident 0: the general kernel, rows_per_block 1, 2, 4 or 8, 1 <= H <= 1024.
// resident 1: the resident kernel (H = 256 and 512 as clusters), for the
// (H, rows_per_block) that dispatch_resident lists.
int trunet_gru_fwd(const void* x_proj, const void* h0, const void* wh, const void* bh,
                   void* out, void* h_last, int rows, int T, int H, int reverse,
                   int rows_per_block, int resident, void* stream) {
  if (rows < 1 || T < 0 || H < 1 || H > 1024) return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const float*>(x_proj), static_cast<const float*>(h0),
               static_cast<const float*>(wh),     static_cast<const float*>(bh),
               static_cast<float*>(out),          static_cast<float*>(h_last),
               nullptr,                           rows, T, H, reverse};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (resident == 1) return (int)dispatch_resident<false>(rows_per_block, a, s);
  if (resident != 0) return (int)cudaErrorInvalidValue;
  if (smem_bytes(H, rows_per_block, true) <= (size_t)max_optin_smem())
    return (int)dispatch_general<true>(rows_per_block, a, s);
  return (int)dispatch_general<false>(rows_per_block, a, s);
}

// The training forward on the resident kernel: the recurrence, also writing
// the residuals saved (rows, T, 4H) = (r, z, n, hn) of every step. For the
// (H, rows_per_tile) that dispatch_resident lists; any other is refused.
// H = 256 and 512 run as clusters, after trunet_gru_fwd_max_clusters(H, 1)
// on this device.
int trunet_gru_fwd_train_resident(const void* x_proj, const void* h0, const void* wh,
                                  const void* bh, void* out, void* h_last, void* saved, int rows,
                                  int T, int H, int reverse, int rows_per_tile, void* stream) {
  if (rows < 1 || T < 0) return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const float*>(x_proj), static_cast<const float*>(h0),
               static_cast<const float*>(wh),     static_cast<const float*>(bh),
               static_cast<float*>(out),          static_cast<float*>(h_last),
               static_cast<float*>(saved),        rows, T, H, reverse};
  return (int)dispatch_resident<true>(rows_per_tile, a, static_cast<cudaStream_t>(stream));
}

// To be called once per device before the cluster path (H = 256, 512) of
// inference (save 0) or training (save 1) is launched there: allows every
// instantiation of H its cluster size and returns the fewest clusters of one
// the device holds at once (0: none can be scheduled); -cudaError_t on
// failure.
int trunet_gru_fwd_max_clusters(int H, int save) {
  int fewest = 1 << 30;
  cudaError_t err = cudaErrorInvalidValue;
#define TRUNET_PREPARE(HH, CS, C, KS, RR)                                   \
  if (H == HH) {                                                            \
    int clusters = 0;                                                       \
    err = save ? resident_prepare<HH, CS, C, KS, RR, true>(&clusters)       \
               : resident_prepare<HH, CS, C, KS, RR, false>(&clusters);     \
    if (err != cudaSuccess) return -(int)err;                               \
    if (clusters < fewest) fewest = clusters;                               \
  }
  TRUNET_PREPARE(256, 8, 4, 8, 1) TRUNET_PREPARE(256, 8, 4, 8, 2)
  TRUNET_PREPARE(256, 8, 4, 8, 4) TRUNET_PREPARE(256, 8, 4, 8, 8)
  TRUNET_PREPARE(512, 16, 4, 16, 1) TRUNET_PREPARE(512, 16, 4, 16, 2)
  TRUNET_PREPARE(512, 16, 4, 16, 3) TRUNET_PREPARE(512, 16, 4, 16, 4)
#undef TRUNET_PREPARE
  return err == cudaSuccess ? fewest : -(int)err;
}

const char* trunet_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
