// count_pn: matching existing pods per (pending pod, term, node).
//
// Replaces the TPU kernel kubernetes_tpu/ops/pallas/domain_count.py
// match_count (history only; its live XLA form is ops/topology.py _count_pn
// on ops/exprs.py eval_selector_set). The TPU version contracted a selector
// match [E,P,T] against a node one-hot [E,N] on the matrix unit. On Hopper
// the same contraction is a histogram of selector matches by the node of
// each existing pod, which is what this kernel builds:
//
//   cnt[pt, n] = #{ e : epod_valid[e], epod_node[e] == n,
//                       selector pt matches epod_labels[e],
//                       namespace rule of pt admits epod_ns[e] }
//
// for pt = p * T + t. The selector test is eval_exprs as eval_selector_set
// calls it (no numeric operands): expressions AND together, a pad expression
// is neutral, a key outside [0, K) reads as absent, an id-set pad (-1)
// never matches, In / NotIn / Exists / DoesNotExist are ops 0..3 and any
// other op never matches; an invalid (nil) selector matches nothing. The
// namespace rule: the pending pod's own namespace, or ns_mask[pt, ns] when
// ns_explicit[pt] (ids outside [0, NSB) never match). Existing pods whose
// node lies outside [0, N) count nowhere, as under the one-hot.
//
// Bound on this card: bytes, and almost all of them are the output. It is
// P*T*N*4 bytes (8 MiB at 256 pods x 1 term x 8192 nodes) against a few
// hundred KB of existing-pod rows and selectors; the selector work is a few
// integer compares per (existing pod, term). Tensor cores are not used: the
// one-hot has one nonzero per row, so a bf16 wgmma product would spend
// 2*E*P*T*N operations (about 18 GFLOP at the size above, seven times the
// byte bound's time) on multiplying zeros.
//
// Design: every output element is written exactly once, with no zero fill
// and no global atomic. The 1-D grid walks (selector tile, node range)
// pairs: block b owns selectors [pt0, pt0 + S) with
// pt0 = (b / n_ranges) * S and nodes [n0, n0 + node_range) with
// n0 = (b % n_ranges) * node_range, and keeps their S x node_range uint32
// counters in shared memory. The wrapper (ops/topology.py
// count_pn_geometry) picks S, node_range, the threads and the dynamic
// shared memory by measurement; the launcher below refuses a geometry that
// disagrees with the layout. A block
//   1. zeroes its counters and stages its S selectors in shared memory
//      (ops folded with expr_valid, the id sets, validity, the namespace
//      rule and the ns_mask rows) in one pass of independent loads, while
//      the first tile of existing pods is already loading;
//   2. walks the existing pods in coalesced tiles of blockDim * kUnroll,
//      each thread holding kUnroll pods (node, validity, namespace) in
//      registers and loading its next tile before it evaluates this one; a
//      pod whose node lies outside the block's range counts nowhere here;
//   3. for the pods that remain, tests the namespace rule of each of the S
//      selectors, then the selectors' expressions one at a time: for each,
//      the label reads of every (pod, selector) pair still matching are
//      issued together (the [E,K] labels are a few hundred KB and stay in
//      L2), so a tile costs one round trip per expression; each match adds
//      one to its counter with a shared atomicAdd on uint32;
//   4. converts its counters to float32 (exact: a count is at most E, far
//      below 2^24) and stores its [S, node_range] slice of cnt with 16-byte
//      vector stores where N is a multiple of 4, else scalar.
// Every count is an integer summed in uint32, so the result is bit-equal to
// the plain version in any order. The epod tiles are plain coalesced loads,
// pipelined one tile ahead in registers; cp.async or TMA double buffering
// is left until a measurement shows the loads exposed.

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr int kUnroll = 4;       // existing pods per thread per tile
constexpr int kOpNever = 4;      // staged op: Gt / Lt / unknown, never matches
constexpr int kOpNeutral = 5;    // staged op: pad expression, neutral
constexpr int kMaxThreads = 512;
constexpr int kGeometryMismatch = -1;

// The launch's arguments, packed by the wrapper (ops/topology.py count_pn)
// into one array of int64 in this order, so that the host call converts one
// pointer instead of 28 arguments; the kernel takes the struct by value.
// Device pointers are 0 where absent (ns_explicit and ns_mask without
// explicit namespace sets).
struct Args {
  int64_t epod_labels, epod_node, epod_ns, epod_valid;     // [E,K] [E] [E] [E]
  int64_t key, op, vals, expr_valid, valid;                // [PT,X] .. [PT]
  int64_t pod_ns, ns_explicit, ns_mask;                    // [P] [PT] [PT,NSB]
  int64_t cnt, stream;                                     // [PT,N] f32
  int64_t E, K, PT, T, X, V, NSB, N;
  int64_t pt_tile, node_range, n_ranges, blocks, threads, smem_bytes;
};

template <typename P>
__host__ __device__ const P* ptr(int64_t p) {
  return reinterpret_cast<const P*>(p);
}

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~static_cast<size_t>(15);
}

// Byte offsets into the dynamic shared memory. Mirrored by
// ops/topology.py _smem_layout; the launcher checks the two agree.
struct Layout {
  size_t counters, key, op, vals, own_ns, sel_valid, sel_explicit, ns_mask,
      total;
};

__host__ __device__ inline Layout smem_layout(int S, int node_range, int X,
                                              int V, int NSB) {
  const size_t s = static_cast<size_t>(S);
  Layout l;
  size_t o = 0;
  l.counters = o;     o = align16(o + s * node_range * 4);
  l.key = o;          o = align16(o + s * X * 4);
  l.op = o;           o = align16(o + s * X * 4);
  l.vals = o;         o = align16(o + s * X * V * 4);
  l.own_ns = o;       o = align16(o + s * 4);
  l.sel_valid = o;    o = align16(o + s);
  l.sel_explicit = o; o = align16(o + s);
  l.ns_mask = o;      o = align16(o + s * NSB);
  l.total = o;
  return l;
}

// One tile of existing pods held by a thread: the pod's node relative to
// the block's first node (-1 when the pod is invalid, past E or off the
// block's nodes) and its namespace.
struct PodTile {
  int node[kUnroll];
  int ns[kUnroll];
};

__device__ __forceinline__ void load_tile(
    PodTile& t, int base, int E, int n0, int n1,
    const int32_t* __restrict__ epod_node, const int32_t* __restrict__ epod_ns,
    const uint8_t* __restrict__ epod_valid) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int e = base + u * blockDim.x + threadIdx.x;
    const bool in = e < E;
    const int n = in ? __ldg(epod_node + e) : -1;
    const bool ok = in && __ldg(epod_valid + e);
    t.ns[u] = in ? __ldg(epod_ns + e) : 0;
    t.node[u] = (ok && n >= n0 && n < n1) ? n - n0 : -1;
  }
}

// The bits u * S + s, for every pod u of a tile, of a tile's pair mask.
template <int S>
__device__ constexpr uint32_t pair_bits(int s) {
  return static_cast<uint32_t>(((1ull << (kUnroll * S)) - 1ull) /
                               ((1ull << S) - 1ull)) << s;
}

template <int S>
__global__ void __launch_bounds__(kMaxThreads) count_pn_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int E = static_cast<int>(a.E), K = static_cast<int>(a.K);
  const int PT = static_cast<int>(a.PT), T = static_cast<int>(a.T);
  const int X = static_cast<int>(a.X), V = static_cast<int>(a.V);
  const int NSB = static_cast<int>(a.NSB), N = static_cast<int>(a.N);
  const int node_range = static_cast<int>(a.node_range);
  const int32_t* epod_labels = ptr<int32_t>(a.epod_labels);
  const int32_t* epod_node = ptr<int32_t>(a.epod_node);
  const int32_t* epod_ns = ptr<int32_t>(a.epod_ns);
  const uint8_t* epod_valid = ptr<uint8_t>(a.epod_valid);
  const uint8_t* ns_explicit = ptr<uint8_t>(a.ns_explicit);
  const uint8_t* ns_mask = ptr<uint8_t>(a.ns_mask);
  float* cnt = reinterpret_cast<float*>(a.cnt);

  const Layout L = smem_layout(S, node_range, X, V, NSB);
  uint32_t* counters = reinterpret_cast<uint32_t*>(smem + L.counters);
  int* s_key = reinterpret_cast<int*>(smem + L.key);
  int* s_op = reinterpret_cast<int*>(smem + L.op);
  int* s_vals = reinterpret_cast<int*>(smem + L.vals);
  int* s_own = reinterpret_cast<int*>(smem + L.own_ns);
  uint8_t* s_valid = smem + L.sel_valid;
  uint8_t* s_explicit = smem + L.sel_explicit;
  uint8_t* s_nsmask = smem + L.ns_mask;

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int n_ranges = static_cast<int>(a.n_ranges);
  const int pt_block = blockIdx.x / n_ranges;
  const int pt0 = pt_block * S;
  const int rows = min(S, PT - pt0);
  const int n0 = (blockIdx.x - pt_block * n_ranges) * node_range;
  const int n1 = min(n0 + node_range, N);
  const int stride = nthreads * kUnroll;

  // 1. the first tile starts loading; zero the counters, stage selectors
  PodTile cur;
  load_tile(cur, 0, E, n0, n1, epod_node, epod_ns, epod_valid);
  uint4* c4 = reinterpret_cast<uint4*>(counters);
  for (int i = tid; i < S * node_range / 4; i += nthreads)
    c4[i] = make_uint4(0u, 0u, 0u, 0u);
  // one pass over the selectors' regions: every load for index i is issued
  // before any is used, so staging costs one round trip to memory
  const int n_x = S * X, n_v = S * X * V, n_m = ns_mask ? S * NSB : 0;
  const int n_all = max(max(n_x, n_v), max(S, n_m));
  for (int i = tid; i < n_all; i += nthreads) {
    const bool ix = i < n_x && i / X < rows;
    const bool iv = i < n_v && i / (X * V) < rows;
    const bool is = i < rows;
    const bool im = i < n_m && i / NSB < rows;
    const int64_t px = static_cast<int64_t>(pt0) * X + i;
    const int k = ix ? ptr<int32_t>(a.key)[px] : 0;
    const int raw = ix ? ptr<int32_t>(a.op)[px] : 0;
    const bool ev = ix && ptr<uint8_t>(a.expr_valid)[px];
    const int vv = iv ? ptr<int32_t>(a.vals)[static_cast<int64_t>(pt0) * X * V
                                               + i] : -1;
    const bool vd = is && ptr<uint8_t>(a.valid)[pt0 + i];
    const bool ne = is && ns_explicit != nullptr && ns_explicit[pt0 + i];
    const int pn = is ? ptr<int32_t>(a.pod_ns)[(pt0 + i) / T] : 0;
    const uint8_t mm = im ? ns_mask[static_cast<int64_t>(pt0) * NSB + i] : 0;
    if (i < n_x) {
      s_key[i] = k;
      s_op[i] = !ev ? kOpNeutral : (raw >= 0 && raw <= 3) ? raw : kOpNever;
    }
    if (i < n_v) s_vals[i] = vv;
    if (i < S) {
      s_valid[i] = vd;
      s_explicit[i] = vd && ne;
      s_own[i] = pn;
    }
    if (i < n_m) s_nsmask[i] = mm;
  }
  __syncthreads();

  // 2.-3. walk the existing pods, one tile ahead. Bit u * S + s of
  // ``live`` says that pod u of the tile may still match selector s.
  for (int base = 0; base < E; base += stride) {
    PodTile next;
    load_tile(next, base + stride, E, n0, n1, epod_node, epod_ns, epod_valid);
    uint32_t live = 0u;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (cur.node[u] < 0) continue;
      const int ens = cur.ns[u];
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const bool ok = s_valid[s] && (s_explicit[s]
            ? (ens >= 0 && ens < NSB && s_nsmask[s * NSB + ens])
            : ens == s_own[s]);
        live |= static_cast<uint32_t>(ok) << (u * S + s);
      }
    }
    // the expressions in turn (they AND together); each one's label reads
    // for all kUnroll x S pairs are issued together
    for (int x = 0; x < X && live != 0u; ++x) {
      int kx[S], ox[S];
#pragma unroll
      for (int s = 0; s < S; ++s) {
        kx[s] = s_key[s * X + x];
        ox[s] = s_op[s * X + x];
      }
      int v[kUnroll][S];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t row =
            static_cast<int64_t>(base + u * nthreads + tid) * K;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const bool read = ((live >> (u * S + s)) & 1u) &&
                            ox[s] != kOpNeutral && kx[s] >= 0 && kx[s] < K;
          v[u][s] = read ? __ldg(epod_labels + row + kx[s]) : -1;
        }
      }
#pragma unroll
      for (int s = 0; s < S; ++s) {
        if (ox[s] == kOpNeutral || (live & pair_bits<S>(s)) == 0u) continue;
        // id-set membership, the set read from shared memory four values
        // at a time and compared with the tile's kUnroll labels
        uint32_t in_set = 0u;                            // bit u
        const int* set = s_vals + (s * X + x) * V;
        for (int q0 = 0; q0 < V; q0 += 4) {
          int sv[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) sv[j] = q0 + j < V ? set[q0 + j] : -1;
#pragma unroll
          for (int u = 0; u < kUnroll; ++u)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              in_set |= static_cast<uint32_t>(sv[j] >= 0 && sv[j] == v[u][s])
                        << u;
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const bool present = v[u][s] >= 0;
          const bool member = (in_set >> u) & 1u;
          bool match;
          switch (ox[s]) {
            case 0: match = present && member; break;     // In
            case 1: match = !present || !member; break;   // NotIn
            case 2: match = present; break;               // Exists
            case 3: match = !present; break;              // DoesNotExist
            default: match = false; break;                // Gt/Lt: numbers
          }
          if (!match) live &= ~(1u << (u * S + s));
        }
      }
    }
    // each match adds one to its counter
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const uint32_t bits = (live >> (u * S)) & ((1u << S) - 1u);
#pragma unroll
      for (int s = 0; s < S; ++s)
        if ((bits >> s) & 1u)
          atomicAdd(counters + s * node_range + cur.node[u], 1u);
    }
    cur = next;
  }
  __syncthreads();

  // 4. each output element of the block's slice, written once
  const int span = n1 - n0;
  const bool vec = (N % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(cnt) % 16 == 0);
  if (vec) {
    const int q4 = span / 4;
    for (int i = tid; i < rows * q4; i += nthreads) {
      const int s = i / q4;
      const int c = i - s * q4;
      const uint4 v = c4[(s * node_range) / 4 + c];
      const float4 f = make_float4(__uint2float_rn(v.x), __uint2float_rn(v.y),
                                   __uint2float_rn(v.z), __uint2float_rn(v.w));
      *reinterpret_cast<float4*>(
          cnt + static_cast<int64_t>(pt0 + s) * N + n0 + 4 * c) = f;
    }
  } else {
    for (int i = tid; i < rows * span; i += nthreads) {
      const int s = i / span;
      const int c = i - s * span;
      cnt[static_cast<int64_t>(pt0 + s) * N + n0 + c] =
          __uint2float_rn(counters[s * node_range + c]);
    }
  }
}

template <int S>
int launch(const Args& a) {
  const int smem_bytes = static_cast<int>(a.smem_bytes);
  // Above 48 KB a block's dynamic shared memory needs an opt-in, made once
  // per device for the largest size asked so far.
  if (smem_bytes > 48 * 1024) {
    static int opted_in[64] = {0};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev >= 64 || smem_bytes > opted_in[dev]) {
      err = cudaFuncSetAttribute(count_pn_kernel<S>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem_bytes);
      if (err != cudaSuccess) return static_cast<int>(err);
      if (dev < 64) opted_in[dev] = smem_bytes;
    }
  }
  count_pn_kernel<S><<<static_cast<unsigned>(a.blocks),
                       static_cast<unsigned>(a.threads), smem_bytes,
                       reinterpret_cast<cudaStream_t>(a.stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on ``stream`` and returns cudaGetLastError() right after the
// launch (0 = launched), or -1 when the array is not ``n_args`` long or
// the geometry is not one the kernel takes: pt_tile outside {1, 2, 4, 8},
// ``smem_bytes`` unlike the layout, a node range not a multiple of 4, or
// threads not a multiple of 32 up to 512.
extern "C" int count_pn_launch(const int64_t* packed, int n_args) {
  if (n_args < 0 || n_args * sizeof(int64_t) != sizeof(Args))
    return kGeometryMismatch;
  Args a;
  memcpy(&a, packed, sizeof(Args));
  const Layout l = smem_layout(static_cast<int>(a.pt_tile),
                               static_cast<int>(a.node_range),
                               static_cast<int>(a.X), static_cast<int>(a.V),
                               static_cast<int>(a.NSB));
  if (l.total != static_cast<size_t>(a.smem_bytes) || a.node_range % 4 != 0 ||
      a.node_range <= 0 || a.threads % 32 != 0 || a.threads <= 0 ||
      a.threads > kMaxThreads)
    return kGeometryMismatch;
  switch (a.pt_tile) {
    case 1: return launch<1>(a);
    case 2: return launch<2>(a);
    case 4: return launch<4>(a);
    case 8: return launch<8>(a);
    default: return kGeometryMismatch;
  }
}
