// Persistent ray slots of the sphere-trace march K2 (fused_march.cu) and the
// shadow march K4 (fused_shadow.cu): one block a SM holds M slots, the rows
// of the tiled SDF (mlp_tiled.cuh).  A step evaluates the SDF of every live
// slot at once; a slot whose ray is done takes the next ray from a global
// queue (one atomicAdd a warp on a counter the launch zeroes); once the
// queue is dry the live slots move to the front rows and a step evaluates
// only the first M, M / 2, ... rows (down to 32 in K2, 8 in K4), so a
// step's cost follows the live rows in the tail.  A ray's state lives in
// global memory, so its result depends on its own evaluations only.
//
// The march's rays come in as a parameter A with
//   int n, max_steps, first, slots; rays, evaluations a ray may take, the
//                                   slots a block fills before its first step
//                                   and after it (at most M)
//   int* queue;                     the next ray to hand out
//   unsigned long long* stats;      nullptr, or [3] += steps, rows, live rows
//   const float* ro, * rd;          [n][3]
//   bool enter(int g) const;        ray g enters a slot: starts its state and
//                                   -> true if it needs an evaluation, else
//                                   writes its result -> false
//   float march_depth(int g) const; its depth now
// and each kernel keeps its own per-ray update after the step.
#pragma once

// The block's slots and counters, in shared memory after the tile.
struct NrtSlots {
  unsigned long long* count;    // [3] this block's steps, rows evaluated, live rows
  int* slot;                    // [M] the ray in each slot (row), -1 if none
  int* warp_live;               // [M / 32]
  volatile int* dry;            // the queue handed out its last ray
  __device__ NrtSlots(void* end, int M)
      : count(static_cast<unsigned long long*>(end)),
        slot(reinterpret_cast<int*>(count + 3)),
        warp_live(slot + M),
        dry(warp_live + M / 32) {}
};

__host__ __device__ constexpr size_t nrt_slots_bytes(int M) {
  return 3 * sizeof(unsigned long long) + sizeof(int) * (M + M / 32 + 1);
}

// Threads t < M (whole warps): a free slot takes rays from the queue until
// one needs an evaluation or the queue is dry; a ray that needs none is
// resolved at once (A::enter).
template <typename A>
__device__ __forceinline__ void nrt_march_refill(const A& a, const NrtSlots& Q, bool want) {
  const int t = threadIdx.x, lane = t % 32;
  bool need = want && Q.slot[t] < 0 && !*Q.dry;
  while (__any_sync(0xffffffffu, need)) {
    const unsigned ask = __ballot_sync(0xffffffffu, need);
    int base = 0;
    if (lane == 0) base = atomicAdd(a.queue, __popc(ask));
    base = __shfl_sync(0xffffffffu, base, 0);
    if (need) {
      const int g = base + __popc(ask & ((1u << lane) - 1u));
      if (g >= a.n) {
        *Q.dry = 1;
        need = false;
      } else if (a.enter(g)) {
        Q.slot[t] = g;
        need = false;
      }
    }
  }
}

// Refills the free slots, counts the live ones and, when they fit in fewer
// rows, moves them to the front.  -> the rows the step evaluates (M, M / 2,
// ... down to MIN_ROWS), or 0 when no slot is live (the queue is dry).
template <int M, int MIN_ROWS = 32, typename A>
__device__ __forceinline__ int nrt_march_schedule(const A& a, const NrtSlots& Q, bool first) {
  const int t = threadIdx.x, lane = t % 32;
  if (t < M) nrt_march_refill(a, Q, t < (first ? a.first : a.slots));
  const int s = t < M ? Q.slot[t] : -1;
  const int live = __syncthreads_count(s >= 0);
  if (live == 0) return 0;
  int rows = M;
  while (rows / 2 >= MIN_ROWS && live <= rows / 2) rows /= 2;
  if (rows < M) {   // compact: the live slots, in order, to rows [0, live)
    const unsigned mask = __ballot_sync(0xffffffffu, s >= 0);
    if (t < M && lane == 0) Q.warp_live[t / 32] = __popc(mask);
    __syncthreads();
    if (t < M) {
      int rank = __popc(mask & ((1u << lane) - 1u));
      for (int w = 0; w < t / 32; ++w) rank += Q.warp_live[w];
      if (s >= 0) Q.slot[rank] = s;
      if (t >= live) Q.slot[t] = -1;
    }
    __syncthreads();
  }
  if (t == 0) {
    Q.count[0] += 1;
    Q.count[1] += rows;
    Q.count[2] += live;
  }
  return rows;
}

// The march points of rows [0, rows): a dead row's point is 0, evaluated and
// ignored.
template <typename A>
__device__ __forceinline__ void nrt_march_points(const A& a, const NrtSlots& Q, float* ps,
                                                 int rows) {
  const int t = threadIdx.x;
  if (t >= rows) return;
  const int g = Q.slot[t];
  const float depth = g >= 0 ? a.march_depth(g) : 0.f;
  for (int c = 0; c < 3; ++c)
    ps[t * 3 + c] = g >= 0 ? __fadd_rn(a.ro[(size_t)g * 3 + c],
                                       __fmul_rn(a.rd[(size_t)g * 3 + c], depth))
                           : 0.f;
}

__device__ __forceinline__ void nrt_march_begin(const NrtSlots& Q, int M) {
  for (int i = threadIdx.x; i < M; i += blockDim.x) Q.slot[i] = -1;
  if (threadIdx.x < 3) Q.count[threadIdx.x] = 0;
  if (threadIdx.x == 0) *Q.dry = 0;
}

template <typename A>
__device__ __forceinline__ void nrt_march_finish(const A& a, const NrtSlots& Q) {
  if (threadIdx.x == 0 && a.stats)
    for (int i = 0; i < 3; ++i) atomicAdd(a.stats + i, Q.count[i]);
}
