// Exact k nearest neighbours in float64 on a cell grid, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package computes this in numpy on the
// host. It is the pair work of the post-processing toolbox:
//   * statistical outlier removal, fastliosam_tpu/postprocess/cleanup.py:
//     _knn_mean_dists (lines 13-22), a chunked (2048, N, 3) float64
//     broadcast with the diagonal set to inf (np.fill_diagonal) and
//     np.partition for the k smallest, any k < N;
//   * the 2D ICP's nearest neighbour, fastliosam_tpu/postprocess/align.py:
//     icp_2d_with_scale (d2.argmin(1), lines 118-120), at k = 1 with the
//     2D points padded with z = 0 (d2 gains +0.0: unchanged).
//
// For each query i of src (N, 3): the k destinations j of dst (M, 3) with
// the smallest d2 = (dx*dx + dy*dy) + dz*dz, dx = src[i].x - dst[j].x,
// ascending in (d2, j) (ties to the lowest j); with exclude_self j == i is
// skipped. Every product and sum is rounded on its own (__dmul_rn /
// __dadd_rn / __dsub_rn), in numpy's order, so nvcc cannot contract them
// into FMAs: d2 equals numpy's and the plain version's
// (ops/kneighbors_cuda.py: knn_ref) bit for bit, for any 1 <= k <= M (minus
// one with exclude_self). Finite inputs.
//
// Bound on the card. Brute force tests all N x M pairs, 8 FP64
// instructions each: at the exported map's 348,097 points that is 57.9 ms
// at 16.75e12 FP64 instructions a second. But the map is a LiDAR surface,
// and a query's k neighbours lie within decimetres: the grid search tests
// ~170 pairs a query there (chip_smoke.py prints the mean), so its own
// bound is the larger of the bytes (points read once, k neighbours
// written) and the pair tests it makes, ~0.04 ms at that size. What it
// waits on is latency: one query a thread holds its list in ~220
// registers (8 warps an SM), and each cell costs a dependent hash probe
// and dependent point loads.
//
// Design:
//   * Cell index (ops/cell_grid.py: cell_index, plain torch on the card:
//     one sort, one cumulative sum, no host read): fine cells of edge h
//     (from dst's bounding box, under 2^21 a side), their Morton codes, one
//     stable sort, and a coarse level (cells 2^level fine cells wide) whose
//     mean occupancy is nearest ~k + 1 points (every level's cell count
//     comes from one pass over the sorted codes); the points in cell order
//     with their original index (x, y, z, j as 32 bytes). One kernel here
//     (knn_insert_kernel) puts the cells into the cell hash
//     (csrc/cell_hash.cuh) from a cell's code to its points' start | end <<
//     32: a probe is one 16-byte load.
//   * Search (knn_grid_kernel): one thread a query, the queries in cell
//     order so that a warp's queries read the same cells. A query visits
//     rings of cells (its own, then the 26 around it, then the next shell),
//     clipped to the cells that dst occupies, and stops once its k-th best
//     d2 lies strictly below the least d2 that any point outside the
//     visited cube could compute to: the gap from the query to the cube's
//     nearest face that still has points behind it, less a slack of 1e-12
//     of the coordinates' magnitude (a point's floor(p / h) key can put it
//     a few ulps outside its cell, a face's coordinate and the gap round,
//     and a computed d2 sits a few ulps off the exact one: all far below
//     that slack), squared and shrunk by 1e-12. When the cube holds every
//     occupied cell, the query is exact whatever the gap. A cell whose box,
//     by the same slack and shrink, lies strictly beyond the k-th d2 so far
//     is skipped unprobed.
//   * The k-best list: insertion compares (d2, j) lexicographically, since
//     candidates do not arrive in ascending j. For k <= 32 it lives in
//     registers (RegList: template capacities 1, 8, 20 and 32, the
//     insertion fully unrolled, entries moving from the tail by selects,
//     so no dynamic index sends it to local memory); above 32 it lives in
//     the query's own output row (RowList).
//   * A query whose rings grow past a probe budget (an isolated outlier,
//     or a query far from dst) goes to the rescue list (one integer
//     atomicAdd); the rescue pass runs the brute-force kernel over that
//     list only, every M points for each. On the exported map no query is
//     rescued.
//   * Below a destination count measured on the card
//     (ops/kneighbors_cuda.py: GRID_MIN_DST) the brute-force kernel runs
//     instead (the ICP's 150-point calls), with the same lists: the index
//     build would cost more than the pairs.

#include <climits>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "cell_hash.cuh"

namespace {

constexpr int kThreads = 128;  // brute force and grid search: one query a thread
constexpr int kTile = 512;     // brute force: destinations a shared-memory tile (12 KB)
constexpr int kRescueBlocks = 264;  // rescue pass: blocks striding the rescued queries
constexpr int kNoIndex = INT_MAX;

__device__ __forceinline__ double pair_d2(double qx, double qy, double qz, double px,
                                          double py, double pz) {
  const double dx = __dsub_rn(qx, px);
  const double dy = __dsub_rn(qy, py);
  const double dz = __dsub_rn(qz, pz);
  return __dadd_rn(__dadd_rn(__dmul_rn(dx, dx), __dmul_rn(dy, dy)), __dmul_rn(dz, dz));
}

__device__ __forceinline__ bool lex_less(double d, int j, double e, int f) {
  return d < e || (d == e && j < f);
}

// the best (d2, j) so far, ascending, in registers; kd / kj is the k-th, the
// bar a candidate must pass
template <int KCAP>
struct RegList {
  double d[KCAP];
  int j[KCAP];
  double kd;
  int kj;
  int k;

  __device__ __forceinline__ void init(int k_, double*, long long*) {
    k = k_;
#pragma unroll
    for (int p = 0; p < KCAP; ++p) {
      d[p] = CUDART_INF;
      j[p] = kNoIndex;
    }
    kd = CUDART_INF;
    kj = kNoIndex;
  }
  __device__ __forceinline__ bool admits(double dd, int jj) const {
    return lex_less(dd, jj, kd, kj);
  }
  // from the tail: entry p takes entry p - 1 where the new one sorts before
  // that, the new one where it sorts between the two, else stays
  __device__ __forceinline__ void insert(double dd, int jj) {
#pragma unroll
    for (int p = KCAP - 1; p > 0; --p) {
      const bool before = lex_less(dd, jj, d[p - 1], j[p - 1]);
      const bool here = lex_less(dd, jj, d[p], j[p]);
      d[p] = before ? d[p - 1] : (here ? dd : d[p]);
      j[p] = before ? j[p - 1] : (here ? jj : j[p]);
    }
    if (lex_less(dd, jj, d[0], j[0])) {
      d[0] = dd;
      j[0] = jj;
    }
    if (k == KCAP) {
      kd = d[KCAP - 1];
      kj = j[KCAP - 1];
    } else {
#pragma unroll
      for (int p = 0; p < KCAP - 1; ++p) {
        if (p == k - 1) {
          kd = d[p];
          kj = j[p];
        }
      }
    }
  }
  __device__ __forceinline__ void store(double* d2_row, long long* idx_row) const {
#pragma unroll
    for (int p = 0; p < KCAP; ++p) {
      if (p < k) {
        d2_row[p] = d[p];
        idx_row[p] = j[p];
      }
    }
  }
};

// above 32: the list lives in the query's output row (null rows: a thread
// with no query)
struct RowList {
  double* d;
  long long* j;
  double kd;
  int kj;
  int k;

  __device__ __forceinline__ void init(int k_, double* d2_row, long long* idx_row) {
    k = k_;
    d = d2_row;
    j = idx_row;
    if (d != nullptr) {
      for (int p = 0; p < k; ++p) {
        d[p] = CUDART_INF;
        j[p] = kNoIndex;
      }
    }
    kd = CUDART_INF;
    kj = kNoIndex;
  }
  __device__ __forceinline__ bool admits(double dd, int jj) const {
    return lex_less(dd, jj, kd, kj);
  }
  __device__ __forceinline__ void insert(double dd, int jj) {
    int p = k - 1;
    while (p > 0 && lex_less(dd, jj, d[p - 1], (int)j[p - 1])) {
      d[p] = d[p - 1];
      j[p] = j[p - 1];
      --p;
    }
    d[p] = dd;
    j[p] = jj;
    kd = d[k - 1];
    kj = (int)j[k - 1];
  }
  __device__ __forceinline__ void store(double*, long long*) const {}
};


// Brute force, one query a thread: every destination, in tiles staged in
// shared memory (every thread reads the same point: a broadcast). Queries
// 0..n-1, or with `qlist` the *qcount queries listed there (the rescue
// pass), a block's worth at a time.
template <class List>
__global__ void __launch_bounds__(kThreads)
knn_brute_kernel(const double* __restrict__ src, long long n, const double* __restrict__ dst,
                 long long m, int k, int exclude_self, const long long* __restrict__ qlist,
                 const unsigned long long* __restrict__ qcount, double* __restrict__ d2_out,
                 long long* __restrict__ idx_out) {
  __shared__ double tile[kTile * 3];
  const long long count = qlist != nullptr ? (long long)*qcount : n;
  for (long long t0 = blockIdx.x * (long long)kThreads; t0 < count;
       t0 += (long long)gridDim.x * kThreads) {
    const long long t = t0 + threadIdx.x;
    const bool live = t < count;
    const long long i = live ? (qlist != nullptr ? qlist[t] : t) : 0;
    double qx = 0.0, qy = 0.0, qz = 0.0;
    if (live) {
      qx = src[3 * i];
      qy = src[3 * i + 1];
      qz = src[3 * i + 2];
    }
    List list;
    list.init(k, live ? d2_out + i * k : nullptr, live ? idx_out + i * k : nullptr);
    for (long long base = 0; base < m; base += kTile) {
      const int cnt = (int)(m - base < kTile ? m - base : kTile);
      __syncthreads();
      for (int e = threadIdx.x; e < 3 * cnt; e += kThreads) tile[e] = dst[3 * base + e];
      __syncthreads();
      if (!live) continue;
      for (int s = 0; s < cnt; ++s) {
        const double d2 = pair_d2(qx, qy, qz, tile[3 * s], tile[3 * s + 1], tile[3 * s + 2]);
        const int j = (int)(base + s);
        if (list.admits(d2, j) && !(exclude_self && j == i)) list.insert(d2, j);
      }
    }
    if (live) list.store(d2_out + i * k, idx_out + i * k);
  }
}

__device__ __forceinline__ unsigned long long spread3(unsigned long long v) {
  v &= 0x1fffffULL;
  v = (v | (v << 32)) & 0x1f00000000ffffULL;
  v = (v | (v << 16)) & 0x1f0000ff0000ffULL;
  v = (v | (v << 8)) & 0x100f00f00f00f00fULL;
  v = (v | (v << 4)) & 0x10c30c30c30c30c3ULL;
  v = (v | (v << 2)) & 0x1249249249249249ULL;
  return v;
}

// a cell's Morton code, x in the high bit of each triple (ops/cell_grid.py:
// morton)
__device__ __forceinline__ unsigned long long morton3(unsigned x, unsigned y, unsigned z) {
  return (spread3(x) << 2) | (spread3(y) << 1) | spread3(z);
}

// floor(v / 2^s) for any sign
__device__ __forceinline__ long long floor_shift(long long v, int s) {
  return v >= 0 ? v >> s : -((-v - 1) >> s) - 1;
}

// the cell index as the search reads it: the points, the cell hash, and
// what places a cell in space
struct Cells {
  const double2* pts;  // (m, 4) f64 as pairs: (x, y), (z, original index)
  const cell_hash::Slot* slots;  // a cell's code -> start | end << 32
  unsigned long long mask;
  long long base[3];  // the fine keys' base
  double h;  // the fine cell edge
  int level;
  double slack;  // the stop rule's slack for this query
};

// the gap from q to the slab [c, c + 1) of coarse keys along one axis, less
// the slack (>= 0)
__device__ __forceinline__ double slab_gap(double q, long long base, int c, int level, double h,
                                           double slack) {
  const double lo = __dmul_rn((double)(base + ((long long)c << level)), h);
  const double hi = __dmul_rn((double)(base + ((long long)(c + 1) << level)), h);
  return fmax(__dsub_rn(fmax(fmax(__dsub_rn(lo, q), __dsub_rn(q, hi)), 0.0), slack), 0.0);
}

// Probe cell (cx, cy, cz) and offer its points to the list, unless even the
// cell's nearest corner lies beyond the list's k-th d2: then no point of it
// can enter (the least d2 it could compute to, with the stop rule's slack
// and shrink, is strictly above that k-th).
template <class List>
__device__ __forceinline__ void scan_cell(List& list, unsigned long long& pairs,
                                          unsigned long long& probes, const Cells& cells,
                                          int cx, int cy, int cz, double q0,
                                          double q1, double q2, long long i, int exclude_self) {
  if (list.kd != CUDART_INF) {
    const double gx = slab_gap(q0, cells.base[0], cx, cells.level, cells.h, cells.slack);
    const double gy = slab_gap(q1, cells.base[1], cy, cells.level, cells.h, cells.slack);
    const double gz = slab_gap(q2, cells.base[2], cz, cells.level, cells.h, cells.slack);
    const double least =
        __dmul_rn(__dadd_rn(__dadd_rn(__dmul_rn(gx, gx), __dmul_rn(gy, gy)), __dmul_rn(gz, gz)),
                  1.0 - 1e-12);
    if (least > list.kd) return;
  }
  ++probes;
  const unsigned long long code = morton3(cx, cy, cz);
  const long long v = cell_hash::find(cells.slots, cells.mask, cell_hash::mix64(code), code);
  if (v < 0) return;
  const long long b = v & 0xffffffffLL, e = v >> 32;
  for (long long p = b; p < e; ++p) {
    const double2 xy = cells.pts[2 * p];
    const double2 zj = cells.pts[2 * p + 1];
    const double d2 = pair_d2(q0, q1, q2, xy.x, xy.y, zj.x);
    const int j = (int)zj.y;
    if (list.admits(d2, j) && !(exclude_self && j == i)) list.insert(d2, j);
  }
  pairs += (unsigned long long)(e - b);
}

// The grid search: one query a thread, queries in cell order (qorder).
// pts (m, 4): the destinations in cell order as x, y, z, original index;
// slots: the cell hash (a cell's Morton code at the level -> the start and
// end of its points, packed as start | end << 32); fparams: h, the
// largest |coordinate| of dst; iparams: the fine keys' base (3), the fine
// keys' largest (3), the level. stats: [0] queries sent to the rescue
// list, [1] pair tests, [2] cell probes.
template <class List>
__global__ void __launch_bounds__(kThreads)
knn_grid_kernel(const double* __restrict__ src, long long n,
                const long long* __restrict__ qorder, const double* __restrict__ pts,
                const cell_hash::Slot* __restrict__ slots, unsigned long long mask,
                const double* __restrict__ fparams, const long long* __restrict__ iparams,
                int k, int exclude_self, long long probe_cap, double* __restrict__ d2_out,
                long long* __restrict__ idx_out, long long* __restrict__ rescue,
                unsigned long long* __restrict__ stats) {
  const long long t = blockIdx.x * (long long)kThreads + threadIdx.x;
  unsigned long long pairs = 0, probes = 0;
  if (t < n) {
    const long long i = qorder[t];
    const double q0 = src[3 * i], q1 = src[3 * i + 1], q2 = src[3 * i + 2];
    const double h = fparams[0];
    const int level = (int)iparams[6];
    // the query's cell; one beyond 2^24 cells of the occupied keys (or
    // beyond int64 keys, or NaN) goes straight to the rescue pass
    int kq[3], kmax[3];
    bool far = false;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      kmax[a] = (int)(iparams[3 + a] >> level);
      const double f = floor(__ddiv_rn(a == 0 ? q0 : a == 1 ? q1 : q2, h));
      long long c = 0;
      if (fabs(f) < 0x1p60) c = floor_shift((long long)f - iparams[a], level);
      if (!(fabs(f) < 0x1p60) || c < -(1LL << 24) || c > kmax[a] + (1LL << 24)) far = true;
      kq[a] = far ? 0 : (int)c;
    }
    const double slack =
        1e-12 * (fmax(fabs(q0), fmax(fabs(q1), fabs(q2))) + fparams[1] + ldexp(h, level));
    const Cells cells{reinterpret_cast<const double2*>(pts), slots, mask,
                      {iparams[0], iparams[1], iparams[2]}, h, level, slack};
    List list;
    list.init(k, d2_out + i * k, idx_out + i * k);
    bool done = false;
    if (!far) {
      // rings that lie wholly outside the occupied keys hold nothing
      int r = 0;
#pragma unroll
      for (int a = 0; a < 3; ++a) r = max(r, max(-kq[a], kq[a] - kmax[a]));
      for (;; ++r) {
        // the ring: the cells at Chebyshev distance r, clipped to [0, kmax];
        // a column off the x faces holds cells only on a y or z face that
        // lies in range, so the loops jump the columns between
        const int xlo = max(kq[0] - r, 0), xhi = min(kq[0] + r, kmax[0]);
        const int ylo = max(kq[1] - r, 0), yhi = min(kq[1] + r, kmax[1]);
        const int zlo = max(kq[2] - r, 0), zhi = min(kq[2] + r, kmax[2]);
        const bool zface = kq[2] - r >= 0 || kq[2] + r <= kmax[2];
        const bool yzface = zface || kq[1] - r >= 0 || kq[1] + r <= kmax[1];
        for (int cx = xlo; cx <= xhi; ++cx) {
          const bool xe = cx == kq[0] - r || cx == kq[0] + r;
          if (!xe && !yzface) {
            cx = kq[0] + r - 1;
            continue;
          }
          for (int cy = ylo; cy <= yhi; ++cy) {
            const bool e = xe || cy == kq[1] - r || cy == kq[1] + r;
            if (!e && !zface) {
              cy = kq[1] + r - 1;
              continue;
            }
            // on an x or y face every cz; else the two z faces
            const int z0 = e ? zlo : kq[2] - r, z1 = e ? zhi : kq[2] + r, dz = e ? 1 : 2 * r;
            for (int cz = z0; cz <= z1; cz += dz) {
              if (cz < zlo || cz > zhi) continue;
              scan_cell(list, pairs, probes, cells, cx, cy, cz, q0, q1, q2, i, exclude_self);
            }
          }
        }
        // the least distance to a point outside the cube: the nearest face
        // with occupied cells behind it
        double gap = CUDART_INF;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const double qa = a == 0 ? q0 : a == 1 ? q1 : q2;
          if (kq[a] + r + 1 <= kmax[a]) {
            const long long key = iparams[a] + ((long long)(kq[a] + r + 1) << level);
            gap = fmin(gap, __dsub_rn(__dmul_rn((double)key, h), qa));
          }
          if (kq[a] - r - 1 >= 0) {
            const long long key = iparams[a] + ((long long)(kq[a] - r) << level);
            gap = fmin(gap, __dsub_rn(qa, __dmul_rn((double)key, h)));
          }
        }
        if (gap == CUDART_INF) {  // the cube holds every occupied cell
          done = true;
          break;
        }
        const double g = __dsub_rn(gap, slack);
        if (g > 0.0 && list.kd < __dmul_rn(__dmul_rn(g, g), 1.0 - 1e-12)) {
          done = true;
          break;
        }
        if ((long long)probes > probe_cap) break;
      }
    }
    if (done) {
      list.store(d2_out + i * k, idx_out + i * k);
    } else {
      rescue[atomicAdd(stats, 1ULL)] = i;
    }
  }
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    pairs += __shfl_down_sync(0xffffffffu, pairs, off);
    probes += __shfl_down_sync(0xffffffffu, probes, off);
  }
  if ((threadIdx.x & 31) == 0 && (pairs | probes) != 0) {
    atomicAdd(stats + 1, pairs);
    atomicAdd(stats + 2, probes);
  }
}

// One thread a cell (n_cells of them): the cell goes into the hash under
// its code, with its points' start | end << 32.
__global__ void knn_insert_kernel(const long long* __restrict__ cell_start,
                                  const long long* __restrict__ cell_code,
                                  const long long* __restrict__ n_cells,
                                  cell_hash::Slot* slots, unsigned long long mask) {
  const long long c = blockIdx.x * 256LL + threadIdx.x;
  if (c >= *n_cells) return;
  const unsigned long long code = (unsigned long long)cell_code[c];
  cell_hash::insert(slots, mask, cell_hash::mix64(code), code,
                    cell_start[c] | (cell_start[c + 1] << 32));
}

// the register list's capacity for k, 0 above 32 (the row list)
int capacity(int k) {
  const int caps[] = {1, 8, 20, 32};
  for (int c : caps)
    if (k <= c) return c;
  return 0;
}

unsigned grid_of(long long threads, int per_block) {
  return (unsigned)((threads + per_block - 1) / per_block);
}

template <class List>
int brute(const double* src, long long n, const double* dst, long long m, int k,
          int exclude_self, const long long* qlist, const unsigned long long* qcount,
          unsigned blocks, double* d2_out, long long* idx_out, cudaStream_t stream) {
  knn_brute_kernel<List><<<blocks, kThreads, 0, stream>>>(src, n, dst, m, k, exclude_self, qlist,
                                                          qcount, d2_out, idx_out);
  return static_cast<int>(cudaGetLastError());
}

int brute_any(int k, const double* src, long long n, const double* dst, long long m,
              int exclude_self, const long long* qlist, const unsigned long long* qcount,
              unsigned blocks, double* d2_out, long long* idx_out, cudaStream_t stream) {
#define KNN_BRUTE(L) \
  brute<L>(src, n, dst, m, k, exclude_self, qlist, qcount, blocks, d2_out, idx_out, stream)
  switch (capacity(k)) {
    case 1: return KNN_BRUTE(RegList<1>);
    case 8: return KNN_BRUTE(RegList<8>);
    case 20: return KNN_BRUTE(RegList<20>);
    case 32: return KNN_BRUTE(RegList<32>);
    default: return KNN_BRUTE(RowList);
  }
#undef KNN_BRUTE
}

}  // namespace

// Brute force. src (n, 3) and dst (m, 3) float64, d2_out (n, k) float64
// and idx_out (n, k) int64, all contiguous on the device; m < 2^31.
// Launches on `stream` and returns the launch's cudaError_t (0 = success).
extern "C" int knn_launch(const double* src, long long n, const double* dst, long long m,
                          int k, int exclude_self, double* d2_out, long long* idx_out,
                          cudaStream_t stream) {
  if (n <= 0) return 0;
  if (k < 1 || m < k + (exclude_self ? 1 : 0) || m >= INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  return brute_any(k, src, n, dst, m, exclude_self, nullptr, nullptr, grid_of(n, kThreads),
                   d2_out, idx_out, stream);
}

// The cell hash from the index (ops/cell_grid.py: cell_index): cell_start
// (m + 1,) and cell_code (m,) int64, *n_cells of them; slots (mask + 1)
// x 16 bytes filled with -1.
extern "C" int knn_hash_launch(const long long* cell_start, const long long* cell_code,
                               const long long* n_cells, long long m, cell_hash::Slot* slots,
                               unsigned long long mask, cudaStream_t stream) {
  if (m <= 0) return 0;
  knn_insert_kernel<<<grid_of(m, 256), 256, 0, stream>>>(cell_start, cell_code, n_cells, slots,
                                                         mask);
  return static_cast<int>(cudaGetLastError());
}

// The grid search (see knn_grid_kernel for the index's arrays); rescue (n,)
// int64 and stats (3,) uint64, zeroed, on the device.
extern "C" int knn_grid_launch(const double* src, long long n, const long long* qorder,
                               const double* pts, long long m, const cell_hash::Slot* slots,
                               unsigned long long mask, const double* fparams,
                               const long long* iparams, int k, int exclude_self,
                               long long probe_cap, double* d2_out, long long* idx_out,
                               long long* rescue, unsigned long long* stats,
                               cudaStream_t stream) {
  if (n <= 0) return 0;
  if (k < 1 || m < k + (exclude_self ? 1 : 0) || m >= INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = grid_of(n, kThreads);
#define KNN_GRID(L)                                                                           \
  knn_grid_kernel<L><<<blocks, kThreads, 0, stream>>>(                                        \
      src, n, qorder, pts, slots, mask, fparams, iparams, k, exclude_self, probe_cap,        \
      d2_out, idx_out, rescue, stats)
  switch (capacity(k)) {
    case 1: KNN_GRID(RegList<1>); break;
    case 8: KNN_GRID(RegList<8>); break;
    case 20: KNN_GRID(RegList<20>); break;
    case 32: KNN_GRID(RegList<32>); break;
    default: KNN_GRID(RowList); break;
  }
#undef KNN_GRID
  return static_cast<int>(cudaGetLastError());
}

// The rescue pass over the *count queries of `rescue` (written by the grid
// search), against the original dst (m, 3): the brute-force kernel over
// that list.
extern "C" int knn_rescue_launch(const double* src, long long n, const double* dst, long long m,
                                 int k, int exclude_self, const long long* rescue,
                                 const unsigned long long* count, double* d2_out,
                                 long long* idx_out, cudaStream_t stream) {
  if (n <= 0) return 0;
  const long long most = (n + kThreads - 1) / kThreads;
  return brute_any(k, src, n, dst, m, exclude_self, rescue, count,
                   (unsigned)(most < kRescueBlocks ? most : kRescueBlocks), d2_out, idx_out,
                   stream);
}
