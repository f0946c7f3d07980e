// pq_fc: PQ FC as a gather-accumulate over an inner-product LUT, tiled over
// the batch, for Hopper (sm_90a).
//
// Replaces qcnn_tpu/ops/pallas/pq_fc.py `_pq_fc_pallas` (the pallas_call at
// :81, `_kernel`), reached there by `pq_fc_pallas`, strategy "pallas".
//
// Computes  out[b, o] = bias[o] + sum_s LUT[b, s, A[o, s]]
// with LUT (B, S, K) float32 built outside the kernel (ops/lut.build_lut,
// as the JAX entry builds it outside its kernel), A (Cout, S) uint8 in its
// natural layout, bias and out float32. Sums accumulate in float32, in
// order of s inside a split of S, then the splits in order.
//
// Two floors. By the data sheet (each input read once from device memory,
// one float32 add per gathered value) AlexNet fc6 at B=256 is 85 MB in
// 0.025 ms and 2.4e9 adds in 0.036 ms. The floor the design can reach is
// higher: every add takes its own 4-byte operand out of shared memory, and
// an SM's shared memory delivers 128 bytes a clock, one conflict-free warp
// load. 2.4e9 adds / (132 SMs x 32 lanes) is 0.57 M clocks, about 0.33 ms
// at 1.75 GHz (fc7 0.15, fc8 0.14). Wider loads do not lower it: a 16-byte
// load of four rows' values for one id still moves 4 bytes an add, and with
// random ids the quarter warps of such a load collide on banks, where the
// 4-byte load of one row is free of conflicts for K <= 32 (bank = id).
//
// Design, around that floor:
// - the LUT chunk stays in its natural [row][s][k] order, every row at a
//   fixed 4 KB pitch, so a gathered value is one `LDS.32` at
//   [(s k + id) * 4 + row * 4096]: one address per id, the row an immediate;
// - a block owns R batch rows (1, 2, 4, 8 or 16: a small batch does only
//   its own adds) and 512 or 1024 outputs, 1 or 2 to each of 512 threads.
//   At 16 rows x 1024 outputs a launch moves 0.19 bytes through L2 for an
//   add (the LUT staged 4 times, the ids 16), and a thread has 32
//   independent sums and 16 loads to an id;
// - the chunks of S (32 sub-spaces: the rows' LUT spans and every
//   output's ids, 16 of them to one 16-byte word) go through a ring of 2 to
//   4 stages of `cp.async` groups; one block-wide barrier a chunk;
// - where the tiles do not fill the card, S is split across blockIdx.z;
//   the partial sums go to a workspace and pq_tile.cuh's
//   `split_reduce_kernel` adds them in split order, then the bias, so two
//   launches give the same bits.
// Rows, outputs, chunk, stages and splits come from ops/cuda/_plan.py
// `plan_gather`; the launcher only validates them. A LUT whose rows are not
// 16-byte aligned (K % 4 != 0) is copied 4 bytes at a time, and ids whose
// rows are not (S % 16 != 0, or a chunk under 16) with plain loads: the
// same kernel, so K up to 256 and any S run.

#include "pq_tile.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kLutRow = 1024;   // floats between two rows of a staged chunk
constexpr int kMaxStages = 4;

// bytes between two outputs' staged ids (ops/cuda/_plan.py
// `gather_id_pitch`): an odd number of 16-byte units, one spare
__host__ __device__ inline int id_pitch(int chunk) {
  const int units = (chunk + 15) / 16 + 1;
  return 16 * (units + 1 - units % 2);
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool ok) {
  const int n = ok ? 4 : 0;  // !ok writes 4 zero bytes and reads nothing
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most `pending` (0..2) of this thread's groups are in flight
__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending >= 2)
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  else if (pending == 1)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <int R, int P>
__global__ void __launch_bounds__(kThreads)
pq_fc_kernel(const float* __restrict__ lut, const uint8_t* __restrict__ asmt,
             const float* __restrict__ bias, float* __restrict__ out, int nb,
             int s, int k, int cout, int chunk, int chunks_per_split,
             int stages, int add_bias, int lut_vec, int id_vec) {
  constexpr int kOT = kThreads * P;
  extern __shared__ __align__(16) unsigned char smem[];
  const int pitch = id_pitch(chunk);
  const int stage_bytes = R * kLutRow * 4 + kOT * pitch;

  const int tid = threadIdx.x;
  const int o0 = blockIdx.x * kOT;
  const int b0 = blockIdx.y * R;
  const int nrows = min(R, nb - b0);
  const int s_lo = blockIdx.z * chunks_per_split * chunk;
  const int s_hi = min(s, s_lo + chunks_per_split * chunk);
  const int n_it = (s_hi - s_lo + chunk - 1) / chunk;

  // start the copies of chunk `it` into its stage of the ring
  auto stage = [&](int it) {
    unsigned char* buf = smem + (it % stages) * stage_bytes;
    const int s0 = s_lo + it * chunk;
    const int ns = min(chunk, s_hi - s0);
    const int span = ns * k;
    for (int r = 0; r < nrows; ++r) {
      const float* src = lut + (static_cast<long long>(b0 + r) * s + s0) * k;
      float* dst = reinterpret_cast<float*>(buf) + r * kLutRow;
      if (lut_vec) {  // k % 4 == 0: every span starts 16-byte aligned
        for (int i = tid; i < span / 4; i += kThreads)
          pq::cp_async16(pq::smem_u32(dst + 4 * i), src + 4 * i, true);
      } else {
        for (int i = tid; i < span; i += kThreads)
          cp_async4(pq::smem_u32(dst + i), src + i, true);
      }
    }
    uint8_t* ids_s = buf + R * kLutRow * 4;
    if (id_vec) {  // ns % 16 == 0 and every row 16-byte aligned
      const int per = ns / 16;  // 1 or 2
      for (int i = tid; i < kOT * per; i += kThreads) {
        const int oo = per == 2 ? i >> 1 : i;
        const int q = per == 2 ? i & 1 : 0;
        const int o = o0 + oo;
        const bool ok = o < cout;
        pq::cp_async16(
            pq::smem_u32(ids_s + oo * pitch + 16 * q),
            asmt + (ok ? static_cast<long long>(o) * s + s0 + 16 * q : 0),
            ok);
      }
    } else {
      for (int i = tid; i < kOT * ns; i += kThreads) {
        const int oo = i / ns, j = i - oo * ns;
        const int o = o0 + oo;
        ids_s[oo * pitch + j] =
            o < cout ? __ldg(asmt + static_cast<long long>(o) * s + s0 + j)
                     : 0;
      }
    }
  };

  float acc[P][R];
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int r = 0; r < R; ++r) acc[p][r] = 0.f;

  for (int i = 0; i < stages - 1; ++i) {
    if (i < n_it) stage(i);
    cp_async_commit();
  }
  for (int it = 0; it < n_it; ++it) {
    // this thread's copies of chunk `it` have landed; after the barrier
    // everyone's have, and everyone is done with chunk it - 1, whose stage
    // the next copies overwrite
    cp_async_wait(stages - 2);
    __syncthreads();
    if (it + stages - 1 < n_it) stage(it + stages - 1);
    cp_async_commit();

    const unsigned char* buf = smem + (it % stages) * stage_bytes;
    const float* lut_s = reinterpret_cast<const float*>(buf);
    const uint8_t* ids_s = buf + R * kLutRow * 4 + tid * pitch;
    const int ns = min(chunk, s_hi - (s_lo + it * chunk));
    int j = 0;
    for (; j + 16 <= ns; j += 16) {
      uint32_t w[P][4];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const uint4 v = *reinterpret_cast<const uint4*>(
            ids_s + p * kThreads * pitch + j);
        w[p][0] = v.x, w[p][1] = v.y, w[p][2] = v.z, w[p][3] = v.w;
      }
#pragma unroll
      for (int u = 0; u < 16; ++u) {
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const float* l =
              lut_s + (j + u) * k + ((w[p][u / 4] >> (8 * (u % 4))) & 0xff);
#pragma unroll
          for (int r = 0; r < R; ++r) acc[p][r] += l[r * kLutRow];
        }
      }
    }
    for (; j < ns; ++j) {  // a ragged chunk's last ids
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const float* l = lut_s + j * k + ids_s[p * kThreads * pitch + j];
#pragma unroll
        for (int r = 0; r < R; ++r) acc[p][r] += l[r * kLutRow];
      }
    }
  }

  // split z writes its partial sums at z * nb * cout of the workspace
  float* dst = out + static_cast<long long>(blockIdx.z) * nb * cout;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int o = o0 + tid + p * kThreads;
    if (o < cout) {
      const float bo = add_bias ? __ldg(bias + o) : 0.f;
      for (int r = 0; r < nrows; ++r)
        dst[static_cast<long long>(b0 + r) * cout + o] = acc[p][r] + bo;
    }
  }
}

struct Args {
  const float* lut;
  const uint8_t* asmt;
  const float* bias;
  float* out;
  float* ws;
  int nb, s, k, cout, chunk, splits, stages;
};

template <int R, int P>
int launch(const Args& a, cudaStream_t stream) {
  const int n_chunks = (a.s + a.chunk - 1) / a.chunk;
  const int per_split = std::max(1, (n_chunks + a.splits - 1) / a.splits);
  if (a.splits > 1 && (n_chunks + per_split - 1) / per_split != a.splits)
    return static_cast<int>(cudaErrorInvalidValue);  // an empty split
  const int out_tiles = (a.cout + kThreads * P - 1) / (kThreads * P);
  const long long b_tiles = (a.nb + R - 1) / R;
  if (b_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int smem =
      a.stages * (R * kLutRow * 4 + kThreads * P * id_pitch(a.chunk));
  if (smem > pq::kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  static int smem_set = 0;  // per instantiation and process
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        pq_fc_kernel<R, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = smem;
  }
  // 16-byte copies where every staged run starts 16-byte aligned
  const int lut_vec = a.k % 4 == 0 && pq::aligned16(a.lut);
  const int id_vec =
      a.s % 16 == 0 && a.chunk % 16 == 0 && pq::aligned16(a.asmt);
  dim3 grid(out_tiles, static_cast<unsigned>(b_tiles), a.splits);
  pq_fc_kernel<R, P><<<grid, kThreads, smem, stream>>>(
      a.lut, a.asmt, a.bias, a.splits > 1 ? a.ws : a.out, a.nb, a.s, a.k,
      a.cout, a.chunk, per_split, a.stages, a.splits == 1, lut_vec, id_vec);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || a.splits == 1) return static_cast<int>(e);
  const long long n = static_cast<long long>(a.nb) * a.cout;
  pq::split_reduce_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0,
                            stream>>>(a.ws, a.bias, a.out, n, a.cout,
                                      a.splits);
  return static_cast<int>(cudaGetLastError());
}

template <int R>
int launch_rows(const Args& a, int outputs, cudaStream_t stream) {
  if (outputs == kThreads) return launch<R, 1>(a, stream);
  if (outputs == 2 * kThreads) return launch<R, 2>(a, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// `rows` (batch rows a block: 1, 2, 4, 8 or 16), `outputs` (512 or 1024 a
// block), `chunk` (sub-spaces a stage, chunk * k <= 1024), `stages` (2..4)
// and `splits` come from the wrapper's plan; `ws` holds splits x nb x cout
// floats when splits > 1.
extern "C" int pq_fc_launch(const void* lut, const void* asmt,
                            const void* bias, void* out, void* ws, int nb,
                            int s, int k, int cout, int rows, int outputs,
                            int chunk, int stages, int splits,
                            cudaStream_t stream) {
  if (nb == 0 || cout == 0) return 0;
  if (k < 1 || k > 256 || s < 0 || chunk < 1 || chunk * k > kLutRow ||
      stages < 2 || stages > kMaxStages || splits < 1 || splits > 65535 ||
      (splits > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const float*>(lut),
               static_cast<const uint8_t*>(asmt),
               static_cast<const float*>(bias),
               static_cast<float*>(out),
               static_cast<float*>(ws),
               nb, s, k, cout, chunk, splits, stages};
  switch (rows) {
    case 1:
      return launch_rows<1>(a, outputs, stream);
    case 2:
      return launch_rows<2>(a, outputs, stream);
    case 4:
      return launch_rows<4>(a, outputs, stream);
    case 8:
      return launch_rows<8>(a, outputs, stream);
    case 16:
      return launch_rows<16>(a, outputs, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
