// Forward GRU recurrence over a precomputed input projection, for Hopper
// (sm_90a). Built with nvcc into a shared library with a plain C interface
// and called through ctypes (tinyrecurrentunet_torch/ops/cuda_gru.py).
//
// Replaces the TPU kernel `_gru_kernel` of tinyrecurrentunet_tpu/ops/
// pallas_gru.py (wrapper `gru_scan_pallas`). Per step, for every row:
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
// Design. One block owns RPT rows and walks all T steps; thread j owns hidden
// unit j (blockDim.x == H) of each of its rows and computes the three gate
// columns j, H+j, 2H+j of h @ Wh. The block's h lives in shared memory,
// double-buffered, with one __syncthreads() per step. Wh is copied once into
// dynamic shared memory when it fits (48 KB at H=64, 192 KB at H=128, the
// flagship's FGRU and TGRU); otherwise (H=256/512 of large16k: 786 KB, 3 MB)
// it is read from global memory, where it stays in the 50 MB L2. The next
// step's inputs are loaded before the current step's product, so their
// latency hides behind it.
//
// What bounds it on this card: not bytes or FLOPs (a flagship call moves a
// few MB and does ~0.1 GFLOP) but the serial chain of T dependent small
// products, one step's h @ Wh needing the previous step's h. Each step costs
// a block H dependent shared-memory FMA rounds plus a barrier. The TGRU
// (16 rows, H=128) runs 16 blocks of 128 threads on 16 of the 132 SMs; the
// FGRU (one row per frame, 556 for a 4 s clip, T=16) runs 70 blocks of 64
// threads, 8 rows each.
// Making it fast is later work: Wh slices resident in registers, the step
// product on tensor cores (mma.sync / wgmma), the columns of one row tile
// split over several blocks of a cluster sharing h through DSMEM.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

__device__ __forceinline__ float sigmoid_f(float x) { return 1.0f / (1.0f + expf(-x)); }

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
cudaError_t launch(const float* xp, const float* h0, const float* wh, const float* bh,
                   float* out, float* h_last, int rows, int T, int H, int reverse,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(H, RPT, WH_SMEM);
  auto kernel = gru_fwd_kernel<RPT, WH_SMEM>;
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((rows + RPT - 1) / RPT);
  kernel<<<grid, H, smem, stream>>>(xp, h0, wh, bh, out, h_last, rows, T, H, reverse);
  return cudaGetLastError();
}

template <bool WH_SMEM>
cudaError_t dispatch(int rpt, const float* xp, const float* h0, const float* wh,
                     const float* bh, float* out, float* h_last, int rows, int T, int H,
                     int reverse, cudaStream_t stream) {
  switch (rpt) {
    case 1: return launch<1, WH_SMEM>(xp, h0, wh, bh, out, h_last, rows, T, H, reverse, stream);
    case 2: return launch<2, WH_SMEM>(xp, h0, wh, bh, out, h_last, rows, T, H, reverse, stream);
    case 4: return launch<4, WH_SMEM>(xp, h0, wh, bh, out, h_last, rows, T, H, reverse, stream);
    case 8: return launch<8, WH_SMEM>(xp, h0, wh, bh, out, h_last, rows, T, H, reverse, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// 1 when Wh goes to shared memory for this H and rows_per_block, else 0.
int trunet_gru_fwd_wh_in_smem(int H, int rows_per_block) {
  return smem_bytes(H, rows_per_block, true) <= (size_t)max_optin_smem() ? 1 : 0;
}

// Launches the recurrence on `stream`; returns the cudaError_t of the launch.
// rows_per_block is 1, 2, 4 or 8; 1 <= H <= 1024; rows >= 1.
int trunet_gru_fwd(const void* x_proj, const void* h0, const void* wh, const void* bh,
                   void* out, void* h_last, int rows, int T, int H, int reverse,
                   int rows_per_block, void* stream) {
  if (rows < 1 || T < 0 || H < 1 || H > 1024) return (int)cudaErrorInvalidValue;
  const float* xp = static_cast<const float*>(x_proj);
  const float* h0f = static_cast<const float*>(h0);
  const float* whf = static_cast<const float*>(wh);
  const float* bhf = static_cast<const float*>(bh);
  float* outf = static_cast<float*>(out);
  float* hlf = static_cast<float*>(h_last);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (trunet_gru_fwd_wh_in_smem(H, rows_per_block))
    return (int)dispatch<true>(rows_per_block, xp, h0f, whf, bhf, outf, hlf, rows, T, H,
                               reverse, s);
  return (int)dispatch<false>(rows_per_block, xp, h0f, whf, bhf, outf, hlf, rows, T, H,
                              reverse, s);
}

const char* trunet_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
