// The amp_C utility sweeps over flat buffers for Hopper (sm_90a): scale and
// axpby with non-finite flags, each one read of its inputs and one write of
// its output.
//
// Replaces: apex_tpu/ops/packed_optimizer.py, multi_tensor_scale_flat
// (:739, the TPU kernel launched at :789) and multi_tensor_axpby_flat (:813,
// launched at :849). Per element, in fp32:
//   scale:  out = x * scale                 (one rounding)
//   axpby:  out = a * x + b * y             (each product and the sum
//                                            rounded on its own)
// the finite test is made on the fp32 result before its cast to the output
// dtype (fp32/bf16/fp16), as the TPU kernel's jnp.isfinite(out32). Flags are
// kept per ROW of 1024 elements: the scale kernel writes a byte per row of
// the input (1 = the row holds a non-finite result) when asked, and each
// kernel sets a one-byte found flag, zeroed by the caller, when any row is
// bad (every writer stores the same 1, so the order of the stores does not
// matter). The TPU kernels flagged per chunk of rows; a chunk is bad exactly
// when one of its rows is, so found is the same.
//
// scale, a and b are fp32 scalars in device memory, read on the card: the
// loss scaler hands 1 / loss_scale and the clip coefficient over without a
// host read.
//
// The input need not fill whole rows: the last row is cut at n, and the
// elements past n are neither read nor written (the TPU kernel's zero
// padding is finite and never reaches the output, so the flags agree).
//
// What bounds it on the H100: bytes. scale reads 2 or 4 and writes 2 or 4
// bytes an element against one multiply; axpby reads two buffers. Design:
// one warp a row, each lane eight groups of four consecutive elements
// (neighbouring lanes on neighbouring 16-byte fp32 or 8-byte 16-bit groups),
// the row's verdict one __any_sync; a grid-stride loop over rows.
#include "packed_sweep.cuh"

namespace {

using packed_sweep::load4;
using packed_sweep::store1;
using packed_sweep::store4;
using packed_sweep::to_f32;

constexpr int kRow = 1024;              // PackSpec's ROW
constexpr int kGroups = kRow / 4 / 32;  // groups of four a lane owns in a row
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;


// out = x * s (AXPBY false) or a * x + b * y (AXPBY true) over n elements.
template <typename TX, typename TY, typename TO, bool AXPBY>
__global__ void __launch_bounds__(kThreads)
    flat_kernel(const TX* __restrict__ x, const TY* __restrict__ y,
                TO* __restrict__ out, const float* __restrict__ a_p,
                const float* __restrict__ b_p, uint8_t* __restrict__ row_bad,
                uint8_t* __restrict__ found, long long n, long long rows) {
  const float a = *a_p;
  const float b = AXPBY ? *b_p : 0.f;
  const int lane = threadIdx.x & 31;
  const long long warp0 =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const long long n_warps = static_cast<long long>(gridDim.x) * kWarps;
  for (long long r = warp0; r < rows; r += n_warps) {
    bool bad = false;
#pragma unroll
    for (int k = 0; k < kGroups; ++k) {
      const long long e = r * kRow + (k * 32 + lane) * 4;  // first element
      if (e + 4 <= n) {
        float xv[4], yv[4];
        load4(x, e / 4, xv);
        if (AXPBY) load4(y, e / 4, yv);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          xv[j] = AXPBY ? __fadd_rn(__fmul_rn(a, xv[j]), __fmul_rn(b, yv[j]))
                        : __fmul_rn(xv[j], a);
          bad |= !isfinite(xv[j]);
        }
        store4(out, e / 4, xv);
      } else {
        for (long long i = e; i < n && i < e + 4; ++i) {
          float v = to_f32(x[i]);
          v = AXPBY ? __fadd_rn(__fmul_rn(a, v), __fmul_rn(b, to_f32(y[i])))
                    : __fmul_rn(v, a);
          bad |= !isfinite(v);
          store1(out + i, v);
        }
      }
    }
    bad = __any_sync(0xffffffffu, bad);
    if (lane == 0) {
      if (row_bad != nullptr) row_bad[r] = bad ? 1 : 0;
      if (bad) *found = 1;
    }
  }
}

template <typename TX, typename TY, typename TO, bool AXPBY>
cudaError_t launch(const void* x, const void* y, void* out, const float* a,
                   const float* b, uint8_t* row_bad, uint8_t* found,
                   long long n, int sms, cudaStream_t s) {
  const long long rows = (n + kRow - 1) / kRow;
  const long long want = (rows + kWarps - 1) / kWarps;
  const long long cap = static_cast<long long>(sms) * 8;
  const int blocks = static_cast<int>(want < cap ? want : cap);
  flat_kernel<TX, TY, TO, AXPBY><<<blocks, kThreads, 0, s>>>(
      static_cast<const TX*>(x), static_cast<const TY*>(y),
      static_cast<TO*>(out), a, b, row_bad, found, n, rows);
  return cudaGetLastError();
}

int prologue(int device, int* sms) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  return static_cast<int>(e);
}

template <typename TX, typename TY, bool AXPBY>
cudaError_t by_out(int out_dtype, const void* x, const void* y, void* out,
                   const float* a, const float* b, uint8_t* row_bad,
                   uint8_t* found, long long n, int sms, cudaStream_t s) {
  return packed_sweep::by_dtype(out_dtype, [&](auto to) {
    return launch<TX, TY, typename decltype(to)::type, AXPBY>(
        x, y, out, a, b, row_bad, found, n, sms, s);
  });
}

}  // namespace

// out = x * scale over n elements (x, out fp32, bf16 or fp16; every pointer
// 16-byte aligned). row_bad: a byte per row of 1024 elements, (n + 1023) /
// 1024 of them, or null; found: one byte the caller zeroed, set to 1 when
// any result is non-finite. scale points to an fp32 device scalar. Returns
// the cudaError_t of the launch.
extern "C" int apex_scale_flat(const void* x, void* out, const void* scale,
                               void* row_bad, void* found, long long n,
                               int x_dtype, int out_dtype, int device,
                               void* stream) {
  if (n == 0) return 0;
  int sms = 0;
  const int rc = prologue(device, &sms);
  if (rc) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  uint8_t* rb = static_cast<uint8_t*>(row_bad);
  uint8_t* f = static_cast<uint8_t*>(found);
  const cudaError_t e = packed_sweep::by_dtype(x_dtype, [&](auto tx) {
    return by_out<typename decltype(tx)::type, float, false>(
        out_dtype, x, nullptr, out, sc, nullptr, rb, f, n, sms, s);
  });
  return static_cast<int>(e);
}

// out = a * x + b * y over n elements (x, y, out each fp32, bf16 or fp16;
// every pointer 16-byte aligned); found as apex_scale_flat's. a and b point to
// fp32 device scalars.
extern "C" int apex_axpby_flat(const void* x, const void* y, void* out,
                               const void* a, const void* b, void* found,
                               long long n, int x_dtype, int y_dtype,
                               int out_dtype, int device, void* stream) {
  if (n == 0) return 0;
  int sms = 0;
  const int rc = prologue(device, &sms);
  if (rc) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  uint8_t* f = static_cast<uint8_t*>(found);
  const cudaError_t e = packed_sweep::by_dtype(x_dtype, [&](auto tx) {
    return packed_sweep::by_dtype(y_dtype, [&](auto ty) {
      return by_out<typename decltype(tx)::type, typename decltype(ty)::type,
                    true>(out_dtype, x, y, out, af, bf, nullptr, f, n, sms,
                          s);
    });
  });
  return static_cast<int>(e);
}
