// Trainable GRU recurrence for Hopper (sm_90a): the forward pass that saves
// its residuals, the reverse-time BPTT, and the reduction of the hidden-weight
// gradients. Built with nvcc into a shared library with a plain C interface
// and called through ctypes (tinyrecurrentunet_torch/ops/cuda_gru.py,
// `GRURecurrence`).
//
// Replaces the TPU kernels of tinyrecurrentunet_tpu/ops/pallas_gru_vjp.py:
//   `_fwd_kernel` -> gru_fwd_train_kernel (path "general", any H), or at H =
//                    64, 128, 256, 512 the resident kernel of gru_fwd.cu with
//                    its residuals saved (`trunet_gru_fwd_train_resident`)
//   `_bwd_kernel` -> gru_bwd_resident_kernel (H = 64, 128) or gru_bwd_kernel
//                    (d_xp, the dh carry, dh0)
//                    + gru_dw_mma_kernel (H = 64, 128) or gru_dw_partial_kernel
//                    + gru_dw_sum_kernel (dWh, dbh)
// The TPU kernel sums dWh and dbh over rows and time in VMEM scratch as its
// sequential grid walks. Blocks on the card run in parallel, so the sum is a
// kernel of its own: per-block partials over a fixed split of the row-steps
// (on the tensor cores at H = 64 and 128, see the reduction section), then a
// sum over the splits in an order fixed by the shapes. The result is
// bit-identical run to run.
//
// Math per step (gate order r, z, n as torch.nn.GRU; bh inside r * hn):
//   hp = h_prev @ Wh + bh;  r = sigmoid(xr + hr);  z = sigmoid(xz + hz)
//   n = tanh(xn + r * hn);  h = (1 - z) * n + z * h_prev
// Residuals saved[row, t] = (r, z, n, hn), 4H floats.
// Backward, dh = g[t] + carry (the carry starts at g_hT, the gradient of the
// state after the last step walked):
//   dz = dh (h_prev - n) z (1 - z);  dn = dh (1 - z)(1 - n^2)
//   dr = dn hn r (1 - r);  d_xp = (dr, dz, dn);  d_hp = (dr, dz, dn r)
//   carry = dh z + d_hp @ Wh^T
//   dWh = sum over rows and steps of h_prev^T d_hp;  dbh = sum of d_hp
//
// Layouts (all float32, contiguous):
//   x_proj, d_xp (rows, T, 3H)   out, g (rows, T, H)   saved (rows, T, 4H)
//   h0, h_last, g_hT, dh0 (rows, H)   Wh, dWh (H, 3H)   bh, dbh (3H)
// `reverse` walks the forward from T-1 down to 0 and the backward from 0 up;
// outputs stay at their input positions. h_prev of step t is out at the step
// walked before it (t-1, or t+1 for reverse) or h0; no shifted copy is made.
//
// What bounds it on this card. The two recurrences are a serial chain of T
// dependent steps, each a product of a row tile with Wh (forward) or Wh^T
// (BPTT) and one barrier. At the flagship's FGRU (16,064 rows, T 16, H 64)
// there are enough rows to fill the card, so the BPTT's bound is its bytes
// (592 MB, 0.18 ms); at its TGRU (1,024 rows, T 251, H 128) the operations
// (25 GFLOP of float32 FMAs, 0.39 ms), and the serial chain of 251 steps.
//
// gru_fwd_train_kernel<RPT, WH_SMEM> and gru_bwd_kernel<RPT, WH_SMEM> (path
// "general" of the forward and of the BPTT, any 1 <= H <= 1024), as the
// general kernel of gru_fwd.cu: one block owns 1-8 rows and walks all T
// steps, thread j owns hidden unit j; Wh sits in dynamic shared memory when
// it fits (48 KB at H=64, 192 KB at H=128), the backward holds it
// transposed so that thread j reads column j. Each FMA needs a shared load.
// The next step's inputs are loaded before the current step's product.
//
// gru_bwd_resident_kernel<H, C, KS, R> (path "registers" of the BPTT, H =
// 64 and 128, chosen by `bwd_plan` in cuda_gru.py), the design of
// gru_fwd.cu's resident kernel carried over to the transposed product
// carry = dh z + d_hp @ Wh^T, a contraction over 3H to H outputs:
// - Wh stays in registers for the whole call. A group of KS = 8 lanes owns
//   C = 4 output units; lane ks holds the words of their rows of Wh for the
//   3H columns c with (c / 4) % KS == ks: 4 * 3H / 8 registers (96 at H 64,
//   192 at H 128), loaded once a block. Blocks stay on the card (grid: the
//   blocks it holds at once) and walk row tile after row tile.
// - d_hp of the tile is double-buffered in shared memory; a lane reads it as
//   float4 words and feeds each word to C FMA chains, four units per shared
//   load. The KS partial sums of a unit meet by __shfl_xor_sync (one
//   butterfly, then a transposing reduction that leaves unit ks % C with
//   lane ks and its twin ks ^ 4).
// - Each (row, unit) element's gate derivatives are applied once, by the
//   lane of its unit whose twin index ks / C equals row % 2, which keeps the
//   carry and dh z of its elements in registers. That lane fetches the next
//   step's g, r, z, n, hn and h_prev for its elements with 4-byte cp.async
//   copies into its own slots of shared memory before the product, so they
//   land while it runs and hold no registers; one barrier a step.
// - `nvcc -Xptxas -v` (sm_90a, CUDA 12.8): H 64 (128 threads, four blocks an
//   SM): 126 / 128 / 128 registers at 1 / 2 / 4 rows a tile (16 bytes
//   spilled at 4); H 128 (256 threads, one block an SM): 231 / 235 / 245, no
//   spill. Dynamic shared memory 8 * R * 3H + 48 * R * H bytes: 4.6 / 9.2 / 18
//   KB at H 64, 9.2 / 18 / 37 KB at H 128. Built at 1, 2 and 4 rows a tile;
//   8 rows spilled 76 bytes at H 64 and ran slower at both H.
//
// The weight-gradient reduction is a product of (H, N) by (N, 3H), N = rows
// * T, then a sum over its splits, described at their sections below.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

__device__ __forceinline__ float sigmoid_f(float x) { return 1.0f / (1.0f + expf(-x)); }

// ---------------------------------------------------------------- forward

template <int RPT, bool WH_SMEM>
__global__ void gru_fwd_train_kernel(const float* __restrict__ xp, const float* __restrict__ h0,
                                     const float* __restrict__ wh, const float* __restrict__ bh,
                                     float* __restrict__ out, float* __restrict__ h_last,
                                     float* __restrict__ saved, int rows, int T, int H,
                                     int reverse) {
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
      const float hpn = an[r] + bn;
      const float rg = sigmoid_f(xr[r] + (ar[r] + br));
      const float zg = sigmoid_f(xz[r] + (az[r] + bz));
      const float ng = tanhf(xn[r] + rg * hpn);
      const float h = (1.0f - zg) * ng + zg * hc[r * H + j];
      hn[r * H + j] = h;
      if (valid[r]) {
        const size_t rt = (size_t)(row0 + r) * T + t;
        out[rt * H + j] = h;
        float* sv = saved + rt * 4 * H;
        sv[j] = rg;
        sv[H + j] = zg;
        sv[2 * H + j] = ng;
        sv[3 * H + j] = hpn;
      }
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

// --------------------------------------------------------------- backward

// The inputs of one backward step of one row, as thread j reads them.
struct StepIn {
  float g, r, z, n, hn, hp;
};

__device__ __forceinline__ StepIn load_step(const float* __restrict__ g,
                                            const float* __restrict__ out,
                                            const float* __restrict__ saved,
                                            const float* __restrict__ h0, int row, int t, int T,
                                            int H, int j, int reverse) {
  StepIn in;
  const size_t rt = (size_t)row * T + t;
  const float* sv = saved + rt * 4 * H;
  in.g = g[rt * H + j];
  in.r = sv[j];
  in.z = sv[H + j];
  in.n = sv[2 * H + j];
  in.hn = sv[3 * H + j];
  const int tp = reverse ? t + 1 : t - 1;  // the step the forward walked before t
  in.hp = (tp < 0 || tp >= T) ? h0[(size_t)row * H + j] : out[((size_t)row * T + tp) * H + j];
  return in;
}

template <int RPT, bool WH_SMEM>
__global__ void gru_bwd_kernel(const float* __restrict__ g, const float* __restrict__ g_hT,
                               const float* __restrict__ out, const float* __restrict__ saved,
                               const float* __restrict__ h0, const float* __restrict__ wh,
                               float* __restrict__ d_xp, float* __restrict__ dh0, int rows,
                               int T, int H, int reverse) {
  extern __shared__ float smem[];
  const int G = 3 * H;
  float* dbuf = smem;               // [2][RPT][3H] d_hp of the step
  float* wts = smem + 2 * RPT * G;  // [3H][H] Wh transposed, when WH_SMEM
  const int j = threadIdx.x;
  const int row0 = blockIdx.x * RPT;

  if (WH_SMEM) {
    for (int i = j; i < H * G; i += blockDim.x) {
      const int k = i / G;
      wts[(i - k * G) * H + k] = wh[i];
    }
  }

  bool valid[RPT];
  float carry[RPT];
  StepIn cur[RPT];
  const int t0 = reverse ? 0 : T - 1;
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    valid[r] = row0 + r < rows;
    carry[r] = valid[r] ? g_hT[(size_t)(row0 + r) * H + j] : 0.0f;
    cur[r] = StepIn{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (valid[r] && T > 0) cur[r] = load_step(g, out, saved, h0, row0 + r, t0, T, H, j, reverse);
  }
  __syncthreads();

  for (int s = 0; s < T; ++s) {
    const int t = reverse ? s : T - 1 - s;
    float* dhp = dbuf + (s & 1) * RPT * G;
    float zkeep[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const StepIn& in = cur[r];
      const float dh = carry[r] + in.g;
      const float dz = dh * (in.hp - in.n) * in.z * (1.0f - in.z);
      const float dn = dh * (1.0f - in.z) * (1.0f - in.n * in.n);
      const float dr = dn * in.hn * in.r * (1.0f - in.r);
      dhp[r * G + j] = dr;
      dhp[r * G + H + j] = dz;
      dhp[r * G + 2 * H + j] = dn * in.r;
      if (valid[r]) {
        float* dx = d_xp + ((size_t)(row0 + r) * T + t) * G;
        dx[j] = dr;
        dx[H + j] = dz;
        dx[2 * H + j] = dn;
      }
      carry[r] = dh;
      zkeep[r] = in.z;
    }

    // the next step's inputs, loaded while this step's product runs
    const int tn = reverse ? t + 1 : t - 1;
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      if (valid[r] && s + 1 < T) cur[r] = load_step(g, out, saved, h0, row0 + r, tn, T, H, j, reverse);
    }
    __syncthreads();

    float acc[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) acc[r] = 0.0f;
#pragma unroll 4
    for (int c = 0; c < G; ++c) {
      const float w = WH_SMEM ? wts[c * H + j] : wh[(size_t)j * G + c];
#pragma unroll
      for (int r = 0; r < RPT; ++r) acc[r] = fmaf(dhp[r * G + c], w, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < RPT; ++r) carry[r] = carry[r] * zkeep[r] + acc[r];
  }

#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    if (valid[r]) dh0[(size_t)(row0 + r) * H + j] = carry[r];
  }
}

// ---- the BPTT with Wh resident in registers (H = 64, 128)

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
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <int H, int R>
constexpr size_t bwd_resident_smem_bytes() {
  // d_hp of the tile [2][R][3H] + the step inputs of the tile [2][6][R][H]
  return (size_t)(2 * R * 3 * H + 2 * 6 * R * H) * sizeof(float);
}

// grid: min(row tiles, the blocks the card holds at once); a block walks the
// tiles blockIdx.x, blockIdx.x + gridDim.x, ... (Wh is loaded once).
template <int H, int C, int KS, int R>
__global__ void __launch_bounds__(H / C * KS, H == 64 ? 4 : 1)
    gru_bwd_resident_kernel(const float* __restrict__ g, const float* __restrict__ g_hT,
                            const float* __restrict__ out, const float* __restrict__ saved,
                            const float* __restrict__ h0, const float* __restrict__ wh,
                            float* __restrict__ d_xp, float* __restrict__ dh0, int rows, int T,
                            int reverse) {
  constexpr int G = 3 * H;
  constexpr int NT = H / C * KS;      // threads: KS lanes for every C output units
  constexpr int KI = G / (4 * KS);    // float4 words of a d_hp row a lane reads
  constexpr int OWN = KS / C;         // lane sets holding each finished unit
  constexpr int RO = (R + OWN - 1) / OWN;  // (row, unit) elements a lane owns
  constexpr int IN = 6 * R * H;       // one stage of step inputs
  static_assert(G % (4 * KS) == 0 && KS % C == 0 && 32 % KS == 0 && NT % 32 == 0, "shape");
  extern __shared__ __align__(16) float bsm[];
  float* dbuf = bsm;              // [2][R][3H] d_hp of the step
  float* inb = bsm + 2 * R * G;   // [2][6][R][H] g, r, z, n, hn, h_prev of the step

  const int tid = threadIdx.x;
  const int ks = tid % KS;
  const int u0 = (tid / KS) * C;  // first output unit of the lane group
  const int u = u0 + ks % C;      // the unit this lane holds after the reduction
  const int set = ks / C;         // it owns rows r with r % OWN == set

  // w[c][4 i + q] = Wh[u0 + c, (i * KS + ks) * 4 + q]: row u0 + c of Wh is
  // column u0 + c of Wh^T
  float w[C][4 * KI];
#pragma unroll
  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int i = 0; i < KI; ++i) {
#pragma unroll
      for (int q = 0; q < 4; ++q) w[c][4 * i + q] = wh[(size_t)(u0 + c) * G + (i * KS + ks) * 4 + q];
    }
  }

  const int tiles = (rows + R - 1) / R;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int row0 = tile * R;
    // the inputs of step s of this lane's elements into stage s & 1
    const auto fetch = [&](int s) {
      const int t = reverse ? s : T - 1 - s;
      const int tp = reverse ? t + 1 : t - 1;  // the step the forward walked before t
      float* st = inb + (s & 1) * IN;
#pragma unroll
      for (int e = 0; e < RO; ++e) {
        const int r = e * OWN + set;
        if (r >= R || row0 + r >= rows) continue;
        const size_t rt = (size_t)(row0 + r) * T + t;
        const float* sv = saved + rt * 4 * H;
        float* d = st + r * H + u;
        cp_async4(d, g + rt * H + u);
        cp_async4(d + R * H, sv + u);
        cp_async4(d + 2 * R * H, sv + H + u);
        cp_async4(d + 3 * R * H, sv + 2 * H + u);
        cp_async4(d + 4 * R * H, sv + 3 * H + u);
        cp_async4(d + 5 * R * H, (tp < 0 || tp >= T) ? h0 + (size_t)(row0 + r) * H + u
                                                     : out + ((size_t)(row0 + r) * T + tp) * H + u);
      }
      cp_async_commit();
    };

    float carry[RO], dhz[RO];
#pragma unroll
    for (int e = 0; e < RO; ++e) {
      const int r = e * OWN + set;
      carry[e] = (r < R && row0 + r < rows) ? g_hT[(size_t)(row0 + r) * H + u] : 0.0f;
      dhz[e] = 0.0f;
    }
    if (T > 0) fetch(0);

    for (int s = 0; s < T; ++s) {
      const int t = reverse ? s : T - 1 - s;
      float* dhp = dbuf + (s & 1) * R * G;
      const float* st = inb + (s & 1) * IN;
      cp_async_wait_all();  // this lane's inputs of step s have landed
      // each element's gates, once, by the lane that owns it
#pragma unroll
      for (int e = 0; e < RO; ++e) {
        const int r = e * OWN + set;
        if (r >= R) continue;
        const bool valid = row0 + r < rows;
        const float* in = st + r * H + u;
        const float gg = valid ? in[0] : 0.0f;
        const float rg = valid ? in[R * H] : 0.0f;
        const float zg = valid ? in[2 * R * H] : 0.0f;
        const float ng = valid ? in[3 * R * H] : 0.0f;
        const float hn = valid ? in[4 * R * H] : 0.0f;
        const float hp = valid ? in[5 * R * H] : 0.0f;
        const float dh = carry[e] + gg;
        const float dz = dh * (hp - ng) * zg * (1.0f - zg);
        const float dn = dh * (1.0f - zg) * (1.0f - ng * ng);
        const float dr = dn * hn * rg * (1.0f - rg);
        dhp[r * G + u] = dr;
        dhp[r * G + H + u] = dz;
        dhp[r * G + 2 * H + u] = dn * rg;
        if (valid) {
          float* dx = d_xp + ((size_t)(row0 + r) * T + t) * G;
          dx[u] = dr;
          dx[H + u] = dz;
          dx[2 * H + u] = dn;
        }
        dhz[e] = dh * zg;
      }
      if (s + 1 < T) fetch(s + 1);  // lands while the product runs
      __syncthreads();

      // carry = dh z + d_hp @ Wh^T, one row of the tile at a time
      const float4* d4 = reinterpret_cast<const float4*>(dhp);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float acc[C], acc2[C];
#pragma unroll
        for (int c = 0; c < C; ++c) acc[c] = acc2[c] = 0.0f;
#pragma unroll
        for (int i = 0; i < KI; ++i) {
          const float4 v = d4[r * (G / 4) + i * KS + ks];
#pragma unroll
          for (int c = 0; c < C; ++c) {
            acc[c] = fmaf(v.x, w[c][4 * i + 0], acc[c]);
            acc2[c] = fmaf(v.y, w[c][4 * i + 1], acc2[c]);
            acc[c] = fmaf(v.z, w[c][4 * i + 2], acc[c]);
            acc2[c] = fmaf(v.w, w[c][4 * i + 3], acc2[c]);
          }
        }
#pragma unroll
        for (int c = 0; c < C; ++c) acc[c] += acc2[c];
        // sum over the KS lanes: butterflies down to C lanes, then a
        // transposing reduction that leaves unit u0 + ks % C with lane ks
#pragma unroll
        for (int o = KS / 2; o >= C; o >>= 1) {
#pragma unroll
          for (int c = 0; c < C; ++c) acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], o);
        }
#pragma unroll
        for (int o = C / 2; o >= 1; o >>= 1) {
          const bool up = (ks & o) != 0;
#pragma unroll
          for (int j = 0; j < o; ++j) {
            const float send = up ? acc[j] : acc[j + o];
            const float keep = up ? acc[j + o] : acc[j];
            acc[j] = keep + __shfl_xor_sync(0xffffffffu, send, o);
          }
        }
        if (set == r % OWN) carry[r / OWN] = dhz[r / OWN] + acc[0];
      }
    }

#pragma unroll
    for (int e = 0; e < RO; ++e) {
      const int r = e * OWN + set;
      if (r < R && row0 + r < rows) dh0[(size_t)(row0 + r) * H + u] = carry[e];
    }
    __syncthreads();  // the next tile rewrites the d_hp buffers
  }
}

// ------------------------------------------------- weight-gradient reduction
//
// Replaces the dWh / dbh accumulation of the TPU kernel `_bwd_kernel`
// (tinyrecurrentunet_tpu/ops/pallas_gru_vjp.py). Per split of the N = rows * T
// row-steps:
//   part[split, k * 3H + c] = sum_n h_prev[n, k] * d_hp[n, c]
//   part[split, H * 3H + c] = sum_n d_hp[n, c]          (dbh)
// with h_prev[n] the output of the step walked before n or h0, and d_hp the
// staged d_xp with its n third multiplied by the saved r. Nothing shifted or
// multiplied is written to device memory first.
//
// What bounds it on this card. At the flagship's training shapes it is 6.3
// GFLOP over 346 MB (H = 64) and 25 GFLOP over 685 MB (H = 128). As float32
// FMAs outside the tensor cores (67 TFLOP/s) that is 0.09 and 0.38 ms of
// operations against 0.10 and 0.20 ms of bytes at 3.35 TB/s, so a SIMT
// product cannot reach the memory time at H = 128 and barely at H = 64. The
// product therefore runs on the tensor cores, where its four instructions
// per tile (two TF32 at 495 TFLOP/s, two bf16 at 989) ask 0.03 and 0.10 ms:
// the floor of this kernel is the bytes, 0.10 and 0.20 ms.
//
// gru_dw_mma_kernel<H, CH, STAGES> (H = 64, 128; 16-byte aligned tensors).
// - One block of 8 warps owns all H rows of dWh and a slab of 192 columns
//   (all of 3H at H = 64, half at H = 128) for its split, so d_xp and r are
//   read from device memory once and h_prev once per slab. grid (3H / 192,
//   splits); an SM holds two blocks at H = 64 (88 KB of shared memory each)
//   and one at H = 128 (181 KB, 96 accumulators a thread).
// - A ring of staged chunks of 32 row-steps (2 at H = 64, 3 at H = 128),
//   filled by the TMA unit: one bulk copy (cp.async.bulk) per staged row of
//   h_prev, d_xp and r, started by 96 threads right after the barrier that
//   frees the stage, its bytes counted by the stage's mbarrier, on which
//   every warp waits before it reads the chunk. One __syncthreads() a chunk.
//   A staged h_prev row is addressed per row-step (out at the step walked
//   before, or h0 at a row's first step walked), so chunks may cross row
//   boundaries; rows past the split's end are zeroed by hand. (16-byte
//   cp.async copies by all threads cost ~14 address computations a thread
//   and chunk, in the warps that multiply: staging and product added up,
//   0.54 ms at H = 128 where this takes 0.40.)
// - The product: each float32 operand is split in registers into hi =
//   tf32(x) and lo = x - hi. hi * hi runs as TF32 on mma.sync m16n8k8; the two
//   corrections lo_a * b and a * lo_b run as bf16 on mma.sync m16n8k16, one
//   instruction per 16 row-steps where TF32 needs two (4 tensor-core
//   instructions per 16 row-steps and tile instead of the 6 of 3xTF32);
//   float32 accumulators. The corrections are 2^-11 of the product and bf16
//   keeps 8 bits of them, so ~2^-19 per product is lost: this is not float32
//   accuracy. Against the plain version the sums are within 1e-5 of the
//   largest entry, where the float32 SIMT kernel is within 2e-6 (PERF.md has
//   both against float64). Fragments are read
//   from the staged rows as they lie (A = h_prev^T is "row" with m
//   contiguous, B = d_hp is "col" with n contiguous); the rows are padded by
//   8 words, so the 32 lanes of a fragment load hit 32 banks. A lane holds
//   the row-steps t, t+4, t+8, t+12 of 16 for both operands, which serves
//   both instruction shapes: the order of k within a product is free as
//   long as A and B agree. Warps as 2 x 4, a warp tile of (H / 2) x 48.
// - dn * r is applied to the B fragment as it is loaded; dbh is the column
//   sum of the same B fragments (exact float32), kept by the warps of the
//   first row half and reduced over the 4 lanes of a column at the end.
// - Deterministic: a fixed split of N (`dw_splits`), no atomics.
// - `nvcc -Xptxas -v` (sm_90a, CUDA 12.8): H = 64: 128 registers (the cap of
//   two blocks an SM; 56 bytes spilled), 88,064 bytes of dynamic shared
//   memory; H = 128: 255 registers, no spill, 181,248 bytes.
//
// gru_dw_partial_kernel (every other H): the float32 SIMT product of 64 x 64
// output tiles, 4 x 4 outputs a thread, 16 row-steps staged at a time.

constexpr int DW_TILE = 64;     // output tile: 64 rows k of dWh by 64 columns c
constexpr int DW_CHUNK = 16;    // row-steps n staged in shared memory at a time
constexpr int DW_THREADS = 256; // 16 x 16 threads, 4 x 4 outputs each

// grid (ceil(H / 64), ceil(3H / 64), splits).
__global__ void __launch_bounds__(DW_THREADS)
    gru_dw_partial_kernel(const float* __restrict__ out, const float* __restrict__ h0,
                          const float* __restrict__ d_xp, const float* __restrict__ saved,
                          float* __restrict__ part, int rows, int T, int H, int reverse,
                          int n_per_split) {
  __shared__ __align__(16) float a_s[DW_CHUNK][DW_TILE];  // h_prev[n, k0 + kk]
  __shared__ __align__(16) float b_s[DW_CHUNK][DW_TILE];  // d_hp[n, c0 + cc]
  const int G = 3 * H;
  const long long N = (long long)rows * T;
  const int k0 = blockIdx.x * DW_TILE;
  const int c0 = blockIdx.y * DW_TILE;
  const long long n_begin = (long long)blockIdx.z * n_per_split;
  const long long n_end = n_begin + n_per_split < N ? n_begin + n_per_split : N;
  const int tid = threadIdx.x;
  const int tk = tid / 16;  // outputs k0 + 4 tk .. +3
  const int tc = tid % 16;  // outputs c0 + 4 tc .. +3
  const bool bias_rows = blockIdx.x == 0 && tk == 0;

  // staging: thread loads 4 consecutive columns of one staged row-step
  const int ln = tid / 16;
  const int lx = (tid % 16) * 4;

  float acc[4][4];
  float bsum[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    bsum[a] = 0.0f;
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.0f;
  }

  for (long long nc = n_begin; nc < n_end; nc += DW_CHUNK) {
    const long long n = nc + ln;
    float av[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float bv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (n < n_end) {
      const int row = (int)(n / T);
      const int t = (int)(n - (long long)row * T);
      const int tp = reverse ? t + 1 : t - 1;
      const float* hp = (tp < 0 || tp >= T) ? h0 + (size_t)row * H
                                            : out + ((size_t)row * T + tp) * H;
      const float* dx = d_xp + (size_t)n * G;
      const float* sv = saved + (size_t)n * 4 * H;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int k = k0 + lx + q;
        if (k < H) av[q] = hp[k];
        const int c = c0 + lx + q;
        if (c < G) bv[q] = c < 2 * H ? dx[c] : dx[c] * sv[c - 2 * H];  // dn * r
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      a_s[ln][lx + q] = av[q];
      b_s[ln][lx + q] = bv[q];
    }
    __syncthreads();
#pragma unroll
    for (int nn = 0; nn < DW_CHUNK; ++nn) {
      const float4 a4 = *reinterpret_cast<const float4*>(&a_s[nn][tk * 4]);
      const float4 b4 = *reinterpret_cast<const float4*>(&b_s[nn][tc * 4]);
      const float ar[4] = {a4.x, a4.y, a4.z, a4.w};
      const float br[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int a = 0; a < 4; ++a) {
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(ar[a], br[b], acc[a][b]);
      }
      if (bias_rows) {
#pragma unroll
        for (int b = 0; b < 4; ++b) bsum[b] += br[b];
      }
    }
    __syncthreads();
  }

  const size_t stride = (size_t)H * G + G;
  float* p = part + (size_t)blockIdx.z * stride;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int k = k0 + tk * 4 + a;
    if (k >= H) continue;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int c = c0 + tc * 4 + b;
      if (c < G) p[(size_t)k * G + c] = acc[a][b];
    }
  }
  if (bias_rows) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int c = c0 + tc * 4 + b;
      if (c < G) p[(size_t)H * G + c] = bsum[b];
    }
  }
}

// ---- the tensor-core kernel

constexpr int MMA_BN = 192;       // columns of d_hp per block
constexpr int MMA_BP = MMA_BN + 8;
constexpr int MMA_CH = 32;        // row-steps per staged chunk
constexpr int MMA_THREADS = 256;  // 8 warps: 2 over the rows of dWh, 4 over the columns

constexpr size_t dw_mma_smem_bytes(int H, int STAGES) {
  return (size_t)STAGES * MMA_CH * ((H + 8) + MMA_BP + (H + 8)) * sizeof(float);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// mbarrier in shared memory: `count` arrivals complete a phase, once the
// bytes it was told to expect have landed too.
__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_arrive_expect_tx(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Waits for the phase of `parity` to complete; a wait that never ends traps
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  for (unsigned spins = 0;; ++spins) {
    unsigned done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (spins > (1u << 20)) __trap();
  }
}

// One contiguous run of bytes (a multiple of 16, 16-byte aligned at both
// ends) global -> shared by the TMA unit; its bytes are reported to `bar`.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// x = hi + lo with hi = tf32(x).
__device__ __forceinline__ void split_tf32(float x, unsigned& hi, float& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  lo = x - __uint_as_float(hi);
}

// Two floats as bf16 in one register: `lower` in the low half.
__device__ __forceinline__ unsigned pack_bf16(float lower, float upper) {
  unsigned d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(upper), "f"(lower));
  return d;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Stages one chunk of MMA_CH row-steps starting at n0: h_prev rows into as
// [MMA_CH][H + 8], the slab of d_xp into bs [MMA_CH][MMA_BP] and, when the
// slab reaches the n third, r into rs [MMA_CH][H + 8]. One bulk copy per
// staged row, started by the first 3 * MMA_CH threads; thread 0 tells the
// stage's mbarrier how many bytes to expect. Rows past the split's end are
// zeroed by hand.
template <int H>
__device__ __forceinline__ void dw_stage_chunk(float* as, float* bs, float* rs,
                                               unsigned long long* bar,
                                               const float* __restrict__ out,
                                               const float* __restrict__ h0,
                                               const float* __restrict__ d_xp,
                                               const float* __restrict__ saved, int n0,
                                               int n_end, int T, int reverse, int c0,
                                               bool need_r, int tid) {
  constexpr int G = 3 * H, AP = H + 8;
  const int valid = n_end - n0 < MMA_CH ? n_end - n0 : MMA_CH;
  const unsigned row_bytes = (unsigned)((H + MMA_BN + (need_r ? H : 0)) * sizeof(float));
  if (tid == 0) mbar_arrive_expect_tx(bar, (unsigned)valid * row_bytes);
  if (tid >= 3 * MMA_CH) return;
  const int kind = tid / MMA_CH;  // 0: h_prev, 1: d_xp, 2: r
  const int nn = tid - kind * MMA_CH;
  if (kind == 2 && !need_r) return;
  const int n = n0 + nn;
  float* dst = kind == 0 ? as + nn * AP : kind == 1 ? bs + nn * MMA_BP : rs + nn * AP;
  const int words = kind == 1 ? MMA_BN : H;
  if (n >= n_end) {
    for (int i = 0; i < words; ++i) dst[i] = 0.0f;
    return;
  }
  const float* src;
  if (kind == 0) {
    const int row = n / T;
    const int t = n - row * T;
    const int tp = reverse ? t + 1 : t - 1;  // the step the forward walked before t
    src = (tp < 0 || tp >= T) ? h0 + (size_t)row * H : out + ((size_t)row * T + tp) * H;
  } else if (kind == 1) {
    src = d_xp + (size_t)n * G + c0;
  } else {
    src = saved + (size_t)n * 4 * H;
  }
  bulk_copy(dst, src, (unsigned)(words * sizeof(float)), bar);
}

// grid (3H / MMA_BN, splits); dynamic shared memory dw_mma_smem_bytes(H, STAGES).
template <int H, int STAGES>
__global__ void __launch_bounds__(MMA_THREADS, H == 64 ? 2 : 1)
    gru_dw_mma_kernel(const float* __restrict__ out, const float* __restrict__ h0,
                      const float* __restrict__ d_xp, const float* __restrict__ saved,
                      float* __restrict__ part, int rows, int T, int reverse, int n_per_split) {
  constexpr int G = 3 * H, AP = H + 8;
  constexpr int MT = H / 32;  // 16-row tiles of a warp: H / 2 rows
  constexpr int NTL = 6;      // 8-column tiles of a warp: 48 columns
  constexpr int STAGE = MMA_CH * (AP + MMA_BP + AP);
  static_assert(3 * MMA_CH <= MMA_THREADS && MMA_CH % 16 == 0, "one thread per staged row");
  extern __shared__ __align__(16) float dw_smem[];
  __shared__ unsigned long long full[STAGES];  // one mbarrier per stage

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int c0 = blockIdx.x * MMA_BN;
  const long long N = (long long)rows * T;
  const long long nb = (long long)blockIdx.y * n_per_split;
  const int n_begin = (int)(nb < N ? nb : N);
  const int n_end = (int)(nb + n_per_split < N ? nb + n_per_split : N);
  const int nchunks = (n_end - n_begin + MMA_CH - 1) / MMA_CH;
  const bool need_r = c0 + MMA_BN > 2 * H;

  bool n_third[NTL];  // the tile's columns lie in the n third: d_hp = d_xp * r
#pragma unroll
  for (int nt = 0; nt < NTL; ++nt) n_third[nt] = c0 + wn * 48 + nt * 8 >= 2 * H;

  float acc[MT][NTL][4];
  float bsum[NTL];
#pragma unroll
  for (int nt = 0; nt < NTL; ++nt) {
    bsum[nt] = 0.0f;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[mt][nt][v] = 0.0f;
    }
  }

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::);
  }
  __syncthreads();
  const auto stage_chunk = [&](int chunk) {
    const int s = chunk % STAGES;
    float* st = dw_smem + s * STAGE;
    dw_stage_chunk<H>(st, st + MMA_CH * AP, st + MMA_CH * (AP + MMA_BP), &full[s], out, h0, d_xp,
                      saved, n_begin + chunk * MMA_CH, n_end, T, reverse, c0, need_r, tid);
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nchunks) stage_chunk(s);
  }

  for (int i = 0; i < nchunks; ++i) {
    mbar_wait(&full[i % STAGES], (unsigned)(i / STAGES) & 1u);  // chunk i has landed
    __syncthreads();  // chunk i-1 has been consumed by every warp: refill its stage
    if (i + STAGES - 1 < nchunks) stage_chunk(i + STAGES - 1);
    const float* as = dw_smem + (i % STAGES) * STAGE;
    const float* bs = as + MMA_CH * AP;
    const float* rs = bs + MMA_CH * MMA_BP;
#pragma unroll
    for (int k16 = 0; k16 < MMA_CH; k16 += 16) {
      // this lane's row-steps of the 16: t4, t4 + 4, t4 + 8, t4 + 12 (index q)
      unsigned bh[NTL][4], bp[NTL][2], blp[NTL][2];
#pragma unroll
      for (int nt = 0; nt < NTL; ++nt) {
        const int col = wn * 48 + nt * 8 + g;
        float b[4], lo[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          b[q] = bs[(k16 + t4 + 4 * q) * MMA_BP + col];
          if (n_third[nt]) b[q] *= rs[(k16 + t4 + 4 * q) * AP + c0 + col - 2 * H];
          split_tf32(b[q], bh[nt][q], lo[q]);
        }
        if (wm == 0) bsum[nt] += (b[0] + b[1]) + (b[2] + b[3]);
        bp[nt][0] = pack_bf16(b[0], b[1]);
        bp[nt][1] = pack_bf16(b[2], b[3]);
        blp[nt][0] = pack_bf16(lo[0], lo[1]);
        blp[nt][1] = pack_bf16(lo[2], lo[3]);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int row = wm * (H / 2) + mt * 16 + g;
        // a[q][v]: row-step q, dWh row `row + 8 v`
        float a[4][2], lo[4][2];
        unsigned ah[4][2];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
#pragma unroll
          for (int v = 0; v < 2; ++v) {
            a[q][v] = as[(k16 + t4 + 4 * q) * AP + row + 8 * v];
            split_tf32(a[q][v], ah[q][v], lo[q][v]);
          }
        }
        const unsigned ap[4] = {pack_bf16(a[0][0], a[1][0]), pack_bf16(a[0][1], a[1][1]),
                                pack_bf16(a[2][0], a[3][0]), pack_bf16(a[2][1], a[3][1])};
        const unsigned alp[4] = {pack_bf16(lo[0][0], lo[1][0]), pack_bf16(lo[0][1], lo[1][1]),
                                 pack_bf16(lo[2][0], lo[3][0]), pack_bf16(lo[2][1], lo[3][1])};
        const unsigned ah0[4] = {ah[0][0], ah[0][1], ah[1][0], ah[1][1]};
        const unsigned ah1[4] = {ah[2][0], ah[2][1], ah[3][0], ah[3][1]};
#pragma unroll
        for (int nt = 0; nt < NTL; ++nt) {
          const unsigned bh0[2] = {bh[nt][0], bh[nt][1]};
          const unsigned bh1[2] = {bh[nt][2], bh[nt][3]};
          mma_bf16(acc[mt][nt], alp, bp[nt]);   // lo_a * b
          mma_bf16(acc[mt][nt], ap, blp[nt]);   // a * lo_b
          mma_tf32(acc[mt][nt], ah0, bh0);      // hi_a * hi_b, row-steps t4, t4 + 4
          mma_tf32(acc[mt][nt], ah1, bh1);      // and t4 + 8, t4 + 12
        }
      }
    }
  }

  float* p = part + (size_t)blockIdx.y * ((size_t)H * G + G);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int row = wm * (H / 2) + mt * 16 + g;
#pragma unroll
    for (int nt = 0; nt < NTL; ++nt) {
      const int col = c0 + wn * 48 + nt * 8 + 2 * t4;
      *reinterpret_cast<float2*>(p + (size_t)row * G + col) =
          make_float2(acc[mt][nt][0], acc[mt][nt][1]);
      *reinterpret_cast<float2*>(p + (size_t)(row + 8) * G + col) =
          make_float2(acc[mt][nt][2], acc[mt][nt][3]);
    }
  }
  if (wm == 0) {
#pragma unroll
    for (int nt = 0; nt < NTL; ++nt) {
      float v = bsum[nt];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if (t4 == 0) p[(size_t)H * G + c0 + wn * 48 + nt * 8 + g] = v;
    }
  }
}

// dw[i] = sum over the splits p of part[p, i]; i < size = H*3H + 3H.
//
// What bounds it: bytes, splits * size * 4 read once (13 MB at the FGRU's
// 260 splits, 26 MB at the TGRU's 132), which gru_dw_partial has just
// written, so most of it comes from L2. Design (`sum_plan` in cuda_gru.py):
// a block of cols * groups threads owns `cols` float4 words (4 neighbouring
// entries each) of the output; the `groups` lanes of a word sum the splits
// p = group, group + groups, ... (eight 16-byte loads in flight a lane) into
// four accumulators, add them pairwise, then meet by __shfl_xor_sync within
// the warp and through shared memory across warps, each warp's partial added
// in warp order by one thread per entry. The order of the sum is fixed by
// (splits, size, cols, groups): the result is bit-identical run to run, but
// not the sequential sum in split order. One launch, no atomics. A size that
// is not a multiple of 4 leaves the rows of part off 16-byte boundaries: the
// kernel then reads each word's entries one at a time, up to `size`.
constexpr int SUM_MAX_THREADS = 256;

__global__ void __launch_bounds__(SUM_MAX_THREADS)
    gru_dw_sum_kernel(const float* __restrict__ part, float* __restrict__ dw, int splits,
                      int size, int cols, int groups) {
  __shared__ float4 psum[SUM_MAX_THREADS];  // [warp partials][cols]
  const int tid = threadIdx.x;
  const int col = tid % cols, grp = tid / cols;
  const int word = blockIdx.x * cols + col;
  const bool vec = size % 4 == 0;
  const int first = 4 * word;
  const auto load = [&](int p) -> float4 {
    const float* src = part + (size_t)p * size + first;
    if (vec) return __ldg(reinterpret_cast<const float4*>(src));
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (first < size) v.x = __ldg(src);
    if (first + 1 < size) v.y = __ldg(src + 1);
    if (first + 2 < size) v.z = __ldg(src + 2);
    if (first + 3 < size) v.w = __ldg(src + 3);
    return v;
  };
  const auto add = [](float4 a, float4 b) {
    return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
  };

  float4 acc[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) acc[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (first < size) {
    int p = grp;
    for (; p + 7 * groups < splits; p += 8 * groups) {
      float4 v[8];  // eight 16-byte loads in flight
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = load(p + k * groups);
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[k & 3] = add(acc[k & 3], v[k]);
    }
#pragma unroll
    for (int k = 0; k < 7; ++k) {
      if (p + k * groups < splits) acc[k & 3] = add(acc[k & 3], load(p + k * groups));
    }
  }
  float4 s = add(add(acc[0], acc[1]), add(acc[2], acc[3]));

  // the groups of one warp (32 / cols of them when cols < 32)
  for (int o = cols; o < 32; o <<= 1) {
    s.x += __shfl_xor_sync(0xffffffffu, s.x, o);
    s.y += __shfl_xor_sync(0xffffffffu, s.y, o);
    s.z += __shfl_xor_sync(0xffffffffu, s.z, o);
    s.w += __shfl_xor_sync(0xffffffffu, s.w, o);
  }
  const int per_warp = cols < 32 ? 32 / cols : 1;  // groups a warp holds
  const int partials = groups / per_warp;          // one per warp and word
  if (grp % per_warp == 0) psum[(grp / per_warp) * cols + col] = s;
  __syncthreads();
  // one thread per entry adds the partials in order
  for (int e = tid; e < 4 * cols; e += blockDim.x) {
    const int c = e / 4, q = e % 4;
    const int i = 4 * (blockIdx.x * cols + c) + q;
    if (i >= size) continue;
    float v = 0.0f;
    for (int w = 0; w < partials; ++w) {
      const float4 x = psum[w * cols + c];
      v += q == 0 ? x.x : q == 1 ? x.y : q == 2 ? x.z : x.w;
    }
    dw[i] = v;
  }
}

// ------------------------------------------------------------ launching

size_t fwd_smem_bytes(int H, int rpt, bool wh_smem) {
  return (size_t)(2 * rpt * H + (wh_smem ? 3 * H * H : 0)) * sizeof(float);
}

size_t bwd_smem_bytes(int H, int rpt, bool wh_smem) {
  return (size_t)(2 * rpt * 3 * H + (wh_smem ? 3 * H * H : 0)) * sizeof(float);
}

int max_optin_smem() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
      cudaSuccess)
    return 0;
  return bytes;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

struct FwdArgs {
  const float *xp, *h0, *wh, *bh;
  float *out, *h_last, *saved;
  int rows, T, H, reverse;
};

template <int RPT, bool WH_SMEM>
cudaError_t launch_fwd(const FwdArgs& a, cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes(a.H, RPT, WH_SMEM);
  auto kernel = gru_fwd_train_kernel<RPT, WH_SMEM>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<(a.rows + RPT - 1) / RPT, a.H, smem, stream>>>(a.xp, a.h0, a.wh, a.bh, a.out,
                                                          a.h_last, a.saved, a.rows, a.T, a.H,
                                                          a.reverse);
  return cudaGetLastError();
}

struct BwdArgs {
  const float *g, *g_hT, *out, *saved, *h0, *wh;
  float *d_xp, *dh0;
  int rows, T, H, reverse;
};

template <int RPT, bool WH_SMEM>
cudaError_t launch_bwd(const BwdArgs& a, cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes(a.H, RPT, WH_SMEM);
  auto kernel = gru_bwd_kernel<RPT, WH_SMEM>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<(a.rows + RPT - 1) / RPT, a.H, smem, stream>>>(a.g, a.g_hT, a.out, a.saved, a.h0,
                                                          a.wh, a.d_xp, a.dh0, a.rows, a.T,
                                                          a.H, a.reverse);
  return cudaGetLastError();
}

template <bool WH_SMEM>
cudaError_t dispatch_fwd(int rpt, const FwdArgs& a, cudaStream_t stream) {
  switch (rpt) {
    case 1: return launch_fwd<1, WH_SMEM>(a, stream);
    case 2: return launch_fwd<2, WH_SMEM>(a, stream);
    case 4: return launch_fwd<4, WH_SMEM>(a, stream);
    case 8: return launch_fwd<8, WH_SMEM>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <bool WH_SMEM>
cudaError_t dispatch_bwd(int rpt, const BwdArgs& a, cudaStream_t stream) {
  switch (rpt) {
    case 1: return launch_bwd<1, WH_SMEM>(a, stream);
    case 2: return launch_bwd<2, WH_SMEM>(a, stream);
    case 4: return launch_bwd<4, WH_SMEM>(a, stream);
    case 8: return launch_bwd<8, WH_SMEM>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The resident BPTT over min(row tiles, blocks the card holds at once).
template <int H, int C, int KS, int R>
cudaError_t launch_bwd_resident(const BwdArgs& a, cudaStream_t stream) {
  auto kernel = gru_bwd_resident_kernel<H, C, KS, R>;
  constexpr int threads = H / C * KS;
  constexpr size_t smem = bwd_resident_smem_bytes<H, R>();
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem)) !=
      cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int tiles = (a.rows + R - 1) / R;
  const int grid = tiles < per_sm * sms ? tiles : per_sm * sms;
  kernel<<<grid, threads, smem, stream>>>(a.g, a.g_hT, a.out, a.saved, a.h0, a.wh, a.d_xp, a.dh0,
                                          a.rows, a.T, a.reverse);
  return cudaGetLastError();
}

#define TRUNET_BWD_RESIDENT(HH, C, KS, RR) \
  if (a.H == HH && rows_per_tile == RR) return launch_bwd_resident<HH, C, KS, RR>(a, stream);

// The instantiations of the resident BPTT, (H, units and lanes of a lane
// group, rows per tile); any other is refused. Lists `_BWD_RESIDENT` of
// cuda_gru.py.
cudaError_t dispatch_bwd_resident(int rows_per_tile, const BwdArgs& a, cudaStream_t stream) {
  TRUNET_BWD_RESIDENT(64, 4, 8, 1) TRUNET_BWD_RESIDENT(64, 4, 8, 2)
  TRUNET_BWD_RESIDENT(64, 4, 8, 4)
  TRUNET_BWD_RESIDENT(128, 4, 8, 1) TRUNET_BWD_RESIDENT(128, 4, 8, 2)
  TRUNET_BWD_RESIDENT(128, 4, 8, 4)
  return cudaErrorInvalidValue;
}

template <int H, int STAGES>
cudaError_t launch_dw_mma(dim3 grid, const float* out, const float* h0, const float* d_xp,
                          const float* saved, float* part, int rows, int T, int reverse,
                          int n_per_split, cudaStream_t stream) {
  auto kernel = gru_dw_mma_kernel<H, STAGES>;
  const size_t smem = dw_mma_smem_bytes(H, STAGES);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, MMA_THREADS, smem, stream>>>(out, h0, d_xp, saved, part, rows, T, reverse,
                                              n_per_split);
  return cudaGetLastError();
}

bool args_ok(int rows, int T, int H, int rpt) {
  return rows >= 1 && T >= 0 && H >= 1 && H <= 1024 &&
         (rpt == 1 || rpt == 2 || rpt == 4 || rpt == 8);
}

// Wh goes to shared memory when the block's whole buffer fits there.
bool wh_in_smem(size_t bytes_with_wh) { return bytes_with_wh <= (size_t)max_optin_smem(); }

}  // namespace

extern "C" {

// The forward with residuals on `stream`; returns the cudaError_t of the
// launch. rows_per_block is 1, 2, 4 or 8; 1 <= H <= 1024; rows >= 1.
int trunet_gru_fwd_train(const void* x_proj, const void* h0, const void* wh, const void* bh,
                         void* out, void* h_last, void* saved, int rows, int T, int H,
                         int reverse, int rows_per_block, void* stream) {
  if (!args_ok(rows, T, H, rows_per_block)) return (int)cudaErrorInvalidValue;
  const FwdArgs a{static_cast<const float*>(x_proj), static_cast<const float*>(h0),
                  static_cast<const float*>(wh),     static_cast<const float*>(bh),
                  static_cast<float*>(out),          static_cast<float*>(h_last),
                  static_cast<float*>(saved),        rows, T, H, reverse};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wh_in_smem(fwd_smem_bytes(H, rows_per_block, true)))
    return (int)dispatch_fwd<true>(rows_per_block, a, s);
  return (int)dispatch_fwd<false>(rows_per_block, a, s);
}

// The BPTT on `stream`: d_xp and dh0.
// resident 0: the general kernel, same limits as the forward.
// resident 1: Wh in registers, for the (H, rows_per_block) that
// dispatch_bwd_resident lists.
int trunet_gru_bwd(const void* g, const void* g_hT, const void* out, const void* saved,
                   const void* h0, const void* wh, void* d_xp, void* dh0, int rows, int T,
                   int H, int reverse, int rows_per_block, int resident, void* stream) {
  if (rows < 1 || T < 0 || H < 1 || H > 1024) return (int)cudaErrorInvalidValue;
  const BwdArgs a{static_cast<const float*>(g),     static_cast<const float*>(g_hT),
                  static_cast<const float*>(out),   static_cast<const float*>(saved),
                  static_cast<const float*>(h0),    static_cast<const float*>(wh),
                  static_cast<float*>(d_xp),        static_cast<float*>(dh0),
                  rows, T, H, reverse};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (resident == 1) return (int)dispatch_bwd_resident(rows_per_block, a, s);
  if (resident != 0 || !args_ok(rows, T, H, rows_per_block)) return (int)cudaErrorInvalidValue;
  if (wh_in_smem(bwd_smem_bytes(H, rows_per_block, true)))
    return (int)dispatch_bwd<true>(rows_per_block, a, s);
  return (int)dispatch_bwd<false>(rows_per_block, a, s);
}

// Per-split partial sums of dWh and dbh into part (splits, H*3H + 3H);
// splits * n_per_split must cover rows * T. H = 64 and 128 run the
// tensor-core kernel, which needs every tensor aligned to 16 bytes and
// rows * T < 2^31 (anything else is refused); any other H the float32 SIMT
// kernel.
int trunet_gru_dw_partial(const void* out, const void* h0, const void* d_xp, const void* saved,
                          void* part, int rows, int T, int H, int reverse, int splits,
                          int n_per_split, void* stream) {
  if (rows < 1 || T < 1 || H < 1 || splits < 1 || n_per_split < 1 ||
      (long long)splits * n_per_split < (long long)rows * T)
    return (int)cudaErrorInvalidValue;
  const float* outf = static_cast<const float*>(out);
  const float* h0f = static_cast<const float*>(h0);
  const float* dxf = static_cast<const float*>(d_xp);
  const float* svf = static_cast<const float*>(saved);
  float* pf = static_cast<float*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H == 64 || H == 128) {
    const auto misaligned = [](const void* p) { return reinterpret_cast<size_t>(p) % 16 != 0; };
    if (splits > 65535 || (long long)rows * T >= (1LL << 31) || misaligned(out) ||
        misaligned(h0) || misaligned(d_xp) || misaligned(saved) || misaligned(part))
      return (int)cudaErrorInvalidValue;
    const dim3 grid(3 * H / MMA_BN, splits);
    if (H == 64)
      return (int)launch_dw_mma<64, 2>(grid, outf, h0f, dxf, svf, pf, rows, T, reverse,
                                       n_per_split, s);
    return (int)launch_dw_mma<128, 3>(grid, outf, h0f, dxf, svf, pf, rows, T, reverse,
                                      n_per_split, s);
  }
  const dim3 grid((H + DW_TILE - 1) / DW_TILE, (3 * H + DW_TILE - 1) / DW_TILE, splits);
  gru_dw_partial_kernel<<<grid, DW_THREADS, 0, s>>>(outf, h0f, dxf, svf, pf, rows, T, H, reverse,
                                                    n_per_split);
  return (int)cudaGetLastError();
}

// dw (size = H*3H + 3H) = the sum of the partials part (splits, size) over
// the splits, in an order fixed by the arguments (bit-identical run to run,
// not the sequential order). Blocks of cols * groups threads, each owning
// `cols` float4 words of dw; cols and groups are powers of two, their
// product a multiple of 32 up to 256. part must be 16-byte aligned.
int trunet_gru_dw_sum(const void* part, void* dw, int splits, int size, int cols, int groups,
                      void* stream) {
  const auto pow2 = [](int x) { return x > 0 && (x & (x - 1)) == 0; };
  const int threads = cols * groups;
  if (splits < 1 || size < 1 || !pow2(cols) || !pow2(groups) || threads % 32 != 0 ||
      threads > SUM_MAX_THREADS || reinterpret_cast<size_t>(part) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int words = (size + 3) / 4;
  gru_dw_sum_kernel<<<(words + cols - 1) / cols, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), static_cast<float*>(dw), splits, size, cols, groups);
  return (int)cudaGetLastError();
}

const char* trunet_gru_train_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
