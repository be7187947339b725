// count_pn: matching existing pods per (pending pod, term, node).
//
// Replaces the TPU kernel kubernetes_tpu/ops/pallas/domain_count.py
// match_count (history only; its live XLA form is ops/topology.py _count_pn
// on ops/exprs.py eval_selector_set). The TPU version contracted a selector
// match [E,P,T] against a node one-hot [E,N] on the matrix unit. On Hopper
// the same contraction is a scatter-add of selector matches by the node of
// each existing pod, which is what this kernel does:
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
// Design: one thread per (e, pt). blockIdx.y walks pt, so a block shares one
// selector, whose reads hit the cache; threads along x walk e, so the epod
// reads are coalesced. The selector evaluates in registers and a match adds
// 1.0f to cnt[pt * N + node] with atomicAdd into an output the caller has
// zero-filled. Every partial sum is an integer below 2^24, which float32
// holds exactly, so the result is bit-equal to the plain version whatever
// order the atomics run in.
//
// Bound on this card: bytes. The output write is P*T*N*4 bytes (8 MiB at
// 256 pods x 1 term x 8192 nodes) plus the epod reads (E*(K+2)*4 + E bytes)
// and the selectors; the selector work is a few integer compares per (e, pt).
// The kernel writes only the matches; the zero fill is the one full pass
// over the output. A faster design (pods sorted by node, selector tiles in
// shared memory, no atomics) is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;

__global__ void count_pn_kernel(
    const int32_t* __restrict__ epod_labels,   // [E,K]
    const int32_t* __restrict__ epod_node,     // [E]
    const int32_t* __restrict__ epod_ns,       // [E]
    const uint8_t* __restrict__ epod_valid,    // [E]
    int E, int K,
    const int32_t* __restrict__ key,           // [PT,X]
    const int32_t* __restrict__ op,            // [PT,X]
    const int32_t* __restrict__ vals,          // [PT,X,V]
    const uint8_t* __restrict__ expr_valid,    // [PT,X]
    const uint8_t* __restrict__ valid,         // [PT]
    int PT, int T, int X, int V,
    const int32_t* __restrict__ pod_ns,        // [P]
    const uint8_t* __restrict__ ns_explicit,   // [PT] or null
    const uint8_t* __restrict__ ns_mask,       // [PT,NSB] or null
    int NSB,
    float* __restrict__ cnt,                   // [PT,N], zero-filled
    int N) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E || !epod_valid[e]) return;
  const int node = epod_node[e];
  if (node < 0 || node >= N) return;
  const int ens = epod_ns[e];
  const int32_t* labels = epod_labels + static_cast<int64_t>(e) * K;

  for (int pt = blockIdx.y; pt < PT; pt += gridDim.y) {
    if (!valid[pt]) continue;
    bool ns_ok;
    if (ns_explicit != nullptr && ns_explicit[pt]) {
      ns_ok = ens >= 0 && ens < NSB &&
              ns_mask[static_cast<int64_t>(pt) * NSB + ens];
    } else {
      ns_ok = ens == pod_ns[pt / T];
    }
    if (!ns_ok) continue;
    bool ok = true;
    for (int x = 0; x < X && ok; ++x) {
      const int px = pt * X + x;
      if (!expr_valid[px]) continue;  // pad expression: neutral
      const int k = key[px];
      const int v = (k < 0 || k >= K) ? -1 : labels[k];
      const bool present = v >= 0;
      bool in_set = false;
      const int32_t* set = vals + static_cast<int64_t>(px) * V;
      for (int j = 0; j < V; ++j) {
        const int s = set[j];
        in_set |= (s >= 0) & (s == v);
      }
      switch (op[px]) {
        case 0: ok = present && in_set; break;      // In
        case 1: ok = !present || !in_set; break;    // NotIn
        case 2: ok = present; break;                // Exists
        case 3: ok = !present; break;               // DoesNotExist
        default: ok = false; break;                 // Gt/Lt need numbers
      }
    }
    if (ok) atomicAdd(cnt + static_cast<int64_t>(pt) * N + node, 1.0f);
  }
}

}  // namespace

// Launches on ``stream`` and returns cudaGetLastError() right after the
// launch (0 = launched). Nothing to count launches nothing.
extern "C" int count_pn_launch(
    const int32_t* epod_labels, const int32_t* epod_node,
    const int32_t* epod_ns, const uint8_t* epod_valid, int E, int K,
    const int32_t* key, const int32_t* op, const int32_t* vals,
    const uint8_t* expr_valid, const uint8_t* valid,
    int PT, int T, int X, int V,
    const int32_t* pod_ns, const uint8_t* ns_explicit,
    const uint8_t* ns_mask, int NSB,
    float* cnt, int N, void* stream) {
  if (E <= 0 || PT <= 0 || N <= 0 || T <= 0) return 0;
  dim3 grid((E + kThreads - 1) / kThreads, PT < kMaxGridY ? PT : kMaxGridY);
  count_pn_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      epod_labels, epod_node, epod_ns, epod_valid, E, K, key, op, vals,
      expr_valid, valid, PT, T, X, V, pod_ns, ns_explicit, ns_mask, NSB,
      cnt, N);
  return static_cast<int>(cudaGetLastError());
}
