// Stream compaction of the gravity MAC classes for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel compact_class_lists
// (sphexa_tpu/gravity/pallas_compact.py, its _kernel and pallas_call):
// per row of a packed (B, C) int32 array (cls << 24) | idx, the class-0
// (M2P) and class-1 (P2P) values in candidate order, truncated at fixed
// caps, the tails zeroed, and the unclipped counts. The TPU kernel ranks
// lanes with MXU products and stages through a 256-lane window only
// because Mosaic has no lane shuffle; here a warp ranks its lanes with
// shuffles, which is the contract without that blocking.
//
// Design. One CUDA block of CT threads per row. The row streams through in
// tiles of 4 CT candidates: each thread loads its four consecutive
// candidates as one 16-byte word, and the next DEPTH = 4 tiles' words are
// in flight while the current tile ranks (a ring of words in registers).
// Ranking: each
// thread counts its candidates of each class (the two counts packed in one
// int, 16 bits each: a tile holds at most 4 CT of either), a warp
// inclusive scan (__shfl_up_sync) gives each thread the candidates of the
// lanes below it, and the warps' totals, exchanged through shared memory,
// give each warp its offset: one barrier per tile, the totals
// double-buffered by tile parity (a warp writes tile i + 2's totals only
// after the barrier of tile i + 1, which every thread passes after reading
// tile i's). A value goes to list_k[row, done_k + offset] while that index
// is below cap_k, then done_k advances by the tile's count. After the last
// tile the block zeroes list_k past min(done_k, cap_k) and writes the
// unclipped counts. No atomics: the order is the candidate order, so the
// lists are bit-equal to the stable sort of the plain version.
//
// Rows whose start is not 16-byte aligned (C % 4 != 0): each row is read
// as the aligned 16-byte words that cover it, and the candidates of those
// words outside the row (the previous row's tail, the next row's head) are
// masked as dead. An aligned 16-byte word that holds a byte of the array
// lies in the array's allocation (the CUDA and PyTorch allocators hand out
// blocks aligned to, and sized in multiples of, far more than 16 bytes),
// so the read stays in bounds.
//
// The one-row form (compact_row_count + compact_row_scatter, entry
// launch_compact_row) serves the block-time-step compaction of one row of
// due flags (sphexa_tpu/sph/blockdt.py compact_active, which runs the TPU
// kernel over one (1, n) packed row with cap0 = n): the positions of the
// due rows in row order, zeros after, and their count. It reads the (n,)
// bool mask itself: a position is its tile's and lane's, so nothing is
// packed and the row has no 2^24 limit. One block of CT threads a tile of
// RT = 16 CT flags, over every SM, in two launches: the first counts each
// tile's due flags; the second gives each block its tile's offset (the
// sum of the counts of the tiles before it, read from the first launch's
// output) and the total, ranks its threads' 16 flags each by a block scan
// of their popcounts, writes their positions, zeroes its share of the
// tail (grid-stride) and, in block 0, writes the count. The positions are
// the one-block form's list0 over the packed row, bit for bit. Its bound
// is 5 bytes a row (the flag read, the position written): about 1.5 us at
// 10^6 on this card, so its two launches' overhead is most of its time.
//
// What bounds it on this card: device memory. Each packed word is read
// once and each list word written once; per tile a thread issues one
// 16-byte load, ranks with 5 shuffles and 8 shared reads, and writes its
// values. One block a row: the superblock pre-pass has only 500 rows at
// Evrard 125 (fewer than the card's 1,056 resident blocks) and reaches a
// lower share of its bound than the blocks' 3,996 rows (PERF.md), but
// splitting its rows over clusters would save about 0.02 ms a solve.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int CT = 256;   // threads per block
constexpr int DEPTH = 4;  // tiles in flight a thread
constexpr int WARPS = CT / 32;
constexpr int IDX_BITS = 24;
constexpr int32_t IDX_MASK = (1 << IDX_BITS) - 1;
constexpr int32_t DEAD = 2 << IDX_BITS;

// the 16-byte word w of a row, dead past the words that cover it
__device__ __forceinline__ int4 word(const int4* row, int w, int nw) {
    return w < nw ? __ldg(row + w) : make_int4(DEAD, DEAD, DEAD, DEAD);
}

// One tile of a row: this thread's word `cur` (candidates e0 .. e0 + 3 of
// the row) ranked and written; done0/done1 advance by the tile's counts.
__device__ __forceinline__ void rank_tile(int4 cur, int e0, int C, int cap0, int cap1,
                                          int32_t* out0, int32_t* out1, int (*wsum)[WARPS],
                                          int par, int lane, int warp, int& done0,
                                          int& done1) {
    int32_t v[4] = {cur.x, cur.y, cur.z, cur.w};
    int mine = 0;  // this thread's class-0 count | class-1 count << 16
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const int e = e0 + j;
        if (e < 0 || e >= C) v[j] = DEAD;
        const int cls = v[j] >> IDX_BITS;
        mine += (cls == 0) | ((cls == 1) << 16);
    }
    int inc = mine;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, inc, d);
        if (lane >= d) inc += y;
    }
    if (lane == 31) wsum[par][warp] = inc;
    __syncthreads();
    int below = inc - mine, tot = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
        const int s = wsum[par][w];
        tot += s;
        if (w < warp) below += s;
    }
    int p0 = done0 + (below & 0xffff), p1 = done1 + (below >> 16);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const int cls = v[j] >> IDX_BITS;
        if (cls == 0) {
            if (p0 < cap0) out0[p0] = v[j] & IDX_MASK;
            ++p0;
        } else if (cls == 1) {
            if (p1 < cap1) out1[p1] = v[j] & IDX_MASK;
            ++p1;
        }
    }
    done0 += tot & 0xffff;
    done1 += tot >> 16;
}

// DEPTH tiles' words in flight a thread: word i of the ring is tile
// base + i's, reloaded with tile base + i + DEPTH's once ranked.
__global__ void __launch_bounds__(CT)
compact_class_lists_kernel(const int32_t* __restrict__ packed, int C, int cap0, int cap1,
                           int32_t* __restrict__ list0, int32_t* __restrict__ list1,
                           int32_t* __restrict__ counts) {
    __shared__ __align__(16) int wsum[2][WARPS];
    const int row = blockIdx.x;
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    const int32_t* in = packed + static_cast<size_t>(row) * C;
    int32_t* out0 = list0 + static_cast<size_t>(row) * cap0;
    int32_t* out1 = list1 + static_cast<size_t>(row) * cap1;
    // the row's candidates before its first aligned word, and its words
    const int head = static_cast<int>((reinterpret_cast<uintptr_t>(in) >> 2) & 3);
    const int4* words = reinterpret_cast<const int4*>(in - head);
    const int nw = (head + C + 3) >> 2;
    int done0 = 0, done1 = 0;
    int4 ring[DEPTH];
#pragma unroll
    for (int i = 0; i < DEPTH; ++i) ring[i] = word(words, i * CT + t, nw);
    int par = 0;
    for (int base = 0; base < nw; base += DEPTH * CT) {
#pragma unroll
        for (int i = 0; i < DEPTH; ++i) {
            const int w = base + i * CT;  // the tile's first word (block-uniform)
            if (w >= nw) break;
            const int4 cur = ring[i];
            ring[i] = word(words, w + DEPTH * CT + t, nw);
            rank_tile(cur, 4 * (w + t) - head, C, cap0, cap1, out0, out1, wsum, par, lane,
                      warp, done0, done1);
            par ^= 1;
        }
    }
    for (int k = min(done0, cap0) + t; k < cap0; k += CT) out0[k] = 0;
    for (int k = min(done1, cap1) + t; k < cap1; k += CT) out1[k] = 0;
    if (t == 0) {
        counts[2 * row] = done0;
        counts[2 * row + 1] = done1;
    }
}

// the one-row form: a tile of RT flags a block, 16 consecutive a thread
constexpr int RT = 16 * CT;

// bit j set where due[e0 + j] is set, for j < 16 and e0 + j < n
__device__ __forceinline__ unsigned due_bits(const uint8_t* __restrict__ due, int n, int e0) {
    const uint8_t* p = due + e0;
    if (e0 + 16 <= n && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
        const uint4 w = __ldg(reinterpret_cast<const uint4*>(p));
        const unsigned q[4] = {w.x, w.y, w.z, w.w};
        unsigned bits = 0;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            const unsigned m = __vcmpne4(q[k], 0u);  // 0xff in each nonzero byte
            bits |= (((m >> 7) & 1u) | ((m >> 14) & 2u) | ((m >> 21) & 4u) | ((m >> 28) & 8u))
                    << (4 * k);
        }
        return bits;
    }
    unsigned bits = 0;
#pragma unroll
    for (int j = 0; j < 16; ++j)
        if (e0 + j < n && __ldg(p + j)) bits |= 1u << j;
    return bits;
}

// the block's sum of one int a thread, in every thread (two barriers)
__device__ __forceinline__ int block_sum(int v, int* red, int lane, int warp) {
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
    __syncthreads();
    if (lane == 0) red[warp] = v;
    __syncthreads();
    int tot = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) tot += red[w];
    return tot;
}

// each tile's due flags: tile_counts[tile]
__global__ void __launch_bounds__(CT)
compact_row_count(const uint8_t* __restrict__ due, int n, int32_t* __restrict__ tile_counts) {
    __shared__ int red[WARPS];
    const int t = threadIdx.x;
    const int c = __popc(due_bits(due, n, (blockIdx.x * CT + t) * 16));
    const int tot = block_sum(c, red, t & 31, t >> 5);
    if (t == 0) tile_counts[blockIdx.x] = tot;
}

// the tile's due positions written at its offset, the tail zeroed, the count
__global__ void __launch_bounds__(CT)
compact_row_scatter(const uint8_t* __restrict__ due, int n,
                    const int32_t* __restrict__ tile_counts, int32_t* __restrict__ idx,
                    int32_t* __restrict__ count) {
    __shared__ int red[WARPS];
    __shared__ int wsum[WARPS];
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    const int tiles = gridDim.x, me = blockIdx.x;
    int before = 0, all = 0;  // the due flags of the tiles before this one, and of all
    for (int k = t; k < tiles; k += CT) {
        const int c = tile_counts[k];
        all += c;
        if (k < me) before += c;
    }
    before = block_sum(before, red, lane, warp);
    all = block_sum(all, red, lane, warp);
    const int e0 = (me * CT + t) * 16;
    const unsigned bits = due_bits(due, n, e0);
    const int mine = __popc(bits);
    int inc = mine;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, inc, d);
        if (lane >= d) inc += y;
    }
    if (lane == 31) wsum[warp] = inc;
    __syncthreads();
    int at = before + inc - mine;
    for (int w = 0; w < warp; ++w) at += wsum[w];
    for (unsigned b = bits; b; b &= b - 1) idx[at++] = e0 + __ffs(b) - 1;
    for (int k = all + me * CT + t; k < n; k += tiles * CT) idx[k] = 0;
    if (me == 0 && t == 0) *count = all;
}

}  // namespace

extern "C" {

// packed (B, C), list0 (B, cap0), list1 (B, cap1), counts (B, 2): all
// int32, contiguous, on the current device; launched on ``stream``.
int launch_compact_class_lists(const int32_t* packed, int B, int C, int cap0, int cap1,
                               int32_t* list0, int32_t* list1, int32_t* counts,
                               void* stream) {
    if (B <= 0) return 0;
    compact_class_lists_kernel<<<B, CT, 0, static_cast<cudaStream_t>(stream)>>>(
        packed, C, cap0, cap1, list0, list1, counts);
    return static_cast<int>(cudaGetLastError());
}

// the one-row form: due (n,) bool, idx (n,), count (), tile_counts
// (ceil(n / compact_row_tile())) scratch; two launches on ``stream``
int launch_compact_row(const uint8_t* due, int n, int32_t* idx, int32_t* count,
                       int32_t* tile_counts, void* stream) {
    if (n <= 0 || n > (1 << 30)) return static_cast<int>(cudaErrorInvalidValue);
    const int tiles = (n + RT - 1) / RT;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    compact_row_count<<<tiles, CT, 0, st>>>(due, n, tile_counts);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    compact_row_scatter<<<tiles, CT, 0, st>>>(due, n, tile_counts, idx, count);
    return static_cast<int>(cudaGetLastError());
}

// flags of one tile of the one-row form (the wrapper sizes tile_counts by it)
int compact_row_tile() { return RT; }

}  // extern "C"
