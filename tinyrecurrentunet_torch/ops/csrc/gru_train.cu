// Trainable GRU recurrence for Hopper (sm_90a): the forward pass that saves
// its residuals, the reverse-time BPTT, and the reduction of the hidden-weight
// gradients. Built with nvcc into a shared library with a plain C interface
// and called through ctypes (tinyrecurrentunet_torch/ops/cuda_gru.py,
// `GRURecurrence`).
//
// Replaces the TPU kernels of tinyrecurrentunet_tpu/ops/pallas_gru_vjp.py:
//   `_fwd_kernel` -> gru_fwd_train_kernel
//   `_bwd_kernel` -> gru_bwd_kernel (d_xp, the dh carry, dh0)
//                    + gru_dw_partial_kernel + gru_dw_sum_kernel (dWh, dbh)
// The TPU kernel sums dWh and dbh over rows and time in VMEM scratch as its
// sequential grid walks. Blocks on the card run in parallel, and 3H
// accumulators per thread (384 at H=128) would not fit in registers, so the
// sum is a kernel of its own: per-block partials over a fixed split of the
// row-steps, then a sum over the splits in a fixed order. The result is
// deterministic.
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
// dependent steps, each an H- or 3H-long dot product per thread out of
// shared memory and one barrier; bytes and FLOPs are far from their bounds
// (PERF.md). Design as gru_fwd.cu: one block owns 1-8 rows and walks all T
// steps, thread j owns hidden unit j; Wh sits in dynamic shared memory when
// it fits (48 KB at H=64, 192 KB at H=128), the backward holds it
// transposed so that thread j reads column j without bank conflicts. The
// next step's inputs are loaded before the current step's product. The
// weight-gradient reduction is a float32 SIMT product of (H, N) by (N, 3H),
// N = rows * T, bound by FLOPs at the flagship's shapes.
// Making them fast is later work: the step product on tensor cores, the
// BPTT of a row tile split over a cluster, the reduction with wgmma.

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

// ------------------------------------------------- weight-gradient reduction

constexpr int DW_TILE = 64;     // output tile: 64 rows k of dWh by 64 columns c
constexpr int DW_CHUNK = 16;    // row-steps n staged in shared memory at a time
constexpr int DW_THREADS = 256; // 16 x 16 threads, 4 x 4 outputs each

// Partial sums over one split of the N = rows * T row-steps:
//   part[split, k * 3H + c] = sum_n h_prev[n, k] * d_hp[n, c]
//   part[split, H * 3H + c] = sum_n d_hp[n, c]          (dbh)
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

// dw[i] = sum over splits, in split order, of part[split, i]; i < H*3H + 3H.
__global__ void gru_dw_sum_kernel(const float* __restrict__ part, float* __restrict__ dw,
                                  int splits, int size) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= size) return;
  float s = 0.0f;
  for (int p = 0; p < splits; ++p) s += part[(size_t)p * size + i];
  dw[i] = s;
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

// The BPTT on `stream`: d_xp and dh0. Same limits as the forward.
int trunet_gru_bwd(const void* g, const void* g_hT, const void* out, const void* saved,
                   const void* h0, const void* wh, void* d_xp, void* dh0, int rows, int T,
                   int H, int reverse, int rows_per_block, void* stream) {
  if (!args_ok(rows, T, H, rows_per_block)) return (int)cudaErrorInvalidValue;
  const BwdArgs a{static_cast<const float*>(g),     static_cast<const float*>(g_hT),
                  static_cast<const float*>(out),   static_cast<const float*>(saved),
                  static_cast<const float*>(h0),    static_cast<const float*>(wh),
                  static_cast<float*>(d_xp),        static_cast<float*>(dh0),
                  rows, T, H, reverse};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wh_in_smem(bwd_smem_bytes(H, rows_per_block, true)))
    return (int)dispatch_bwd<true>(rows_per_block, a, s);
  return (int)dispatch_bwd<false>(rows_per_block, a, s);
}

// Per-split partial sums of dWh and dbh into part (splits, H*3H + 3H);
// splits * n_per_split must cover rows * T.
int trunet_gru_dw_partial(const void* out, const void* h0, const void* d_xp, const void* saved,
                          void* part, int rows, int T, int H, int reverse, int splits,
                          int n_per_split, void* stream) {
  if (rows < 1 || T < 1 || H < 1 || splits < 1 || n_per_split < 1 ||
      (long long)splits * n_per_split < (long long)rows * T)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((H + DW_TILE - 1) / DW_TILE, (3 * H + DW_TILE - 1) / DW_TILE, splits);
  gru_dw_partial_kernel<<<grid, DW_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(out), static_cast<const float*>(h0),
      static_cast<const float*>(d_xp), static_cast<const float*>(saved),
      static_cast<float*>(part), rows, T, H, reverse, n_per_split);
  return (int)cudaGetLastError();
}

// dw (H*3H + 3H) = the sum of the partials over the splits, in split order.
int trunet_gru_dw_sum(const void* part, void* dw, int splits, int size, void* stream) {
  if (splits < 1 || size < 1) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  gru_dw_sum_kernel<<<(size + threads - 1) / threads, threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(static_cast<const float*>(part),
                                                           static_cast<float*>(dw), splits, size);
  return (int)cudaGetLastError();
}

const char* trunet_gru_train_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
