// Stream join for Hopper (sm_90a), K5: raw Snappy streams put together on
// the card from the streams of their 64 KiB fragments.
//
// New in the port: the JAX package joins a raw stream's block streams on the
// host (snappy_tpu/ops/encode_xla.py::compress_host), one stream a call.
// Here the pages of a whole call are joined in one launch, after K2 has
// encoded every fragment of every page (parallel/distributed.py::
// compress_streams):
//   in:  frags u8[R, frag_w] and olens i32[R], K2's rows (a fragment's
//        headerless stream, olens bytes; olens < 0 for a row K2 refused);
//        frow i32[.] the row of each fragment; per page p, in page order,
//        ffirst i64[n] its first fragment, fcount i32[n] its fragments (< 0
//        for a page refused before K2), ulens i32[n] its length;
//   out: comp u8[cap]: page p's stream at cstarts[p], clens[p] bytes: the
//        varint of ulens[p], then the streams of its fragments in order;
//        clens[p] = -1 for a page refused, one with a fragment K2 refused,
//        or one whose stream would pass cap.
// The streams lie end to end in page order. A refused page keeps the bytes
// its fragments took (none where it had none) and writes nothing outside
// them, so no other page moves or is touched.
//
// The join is a sequence of items: page p is its header, item p + ffirst[p],
// then its fragments. Block b takes the kItems items from b * kItems on. Its
// start in comp is the sum of the lengths of all items before it (a header's
// varint bytes, a fragment's stream bytes), which it sums itself from the
// lengths (ulens, olens) with all its threads: no block waits for another,
// and each reads what lies before it once (a row group: ~9,000 items,
// ~560 blocks, ~20 MB of L2 reads in all). Then thread 0 lays out its items
// and the block copies them, the fragments a byte a thread and stride, the
// headers, cstarts and clens by thread 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Threads a block and items a block; the emulation builds other values.
#ifndef SNAPPY_K5_THREADS
#define SNAPPY_K5_THREADS 256
#endif
#ifndef SNAPPY_K5_ITEMS
#define SNAPPY_K5_ITEMS 16
#endif

constexpr int kThreads = SNAPPY_K5_THREADS;
constexpr int kItems = SNAPPY_K5_ITEMS;
static_assert((kThreads & (kThreads - 1)) == 0, "the reduction halves the block");

// Bytes of the varint of v.
__device__ __forceinline__ int64_t varint_bytes(uint32_t v) {
  return v < (1u << 7) ? 1 : v < (1u << 14) ? 2 : v < (1u << 21) ? 3 : v < (1u << 28) ? 4 : 5;
}

// The header's bytes of page p: its varint, none for a refused page.
__device__ __forceinline__ int64_t header_bytes(const int32_t* fcount, const int32_t* ulens, int64_t p) {
  return fcount[p] >= 0 ? varint_bytes(uint32_t(ulens[p])) : 0;
}

// The bytes fragment f takes: its stream's, none for a row K2 refused.
__device__ __forceinline__ int64_t fragment_bytes(const int32_t* olens, const int32_t* frow, int64_t f) {
  const int32_t m = olens[frow[f]];
  return m > 0 ? m : 0;
}

// The page of item i: the last page whose header item is at or before i
// (the header items p + ffirst[p] rise with p).
__device__ __forceinline__ int64_t page_of(const int64_t* ffirst, int64_t n, int64_t i) {
  int64_t lo = 0, hi = n - 1;
  while (lo < hi) {
    const int64_t mid = (lo + hi + 1) / 2;
    if (mid + ffirst[mid] <= i) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
join_streams_kernel(const uint8_t* __restrict__ frags, int64_t frag_w, const int32_t* __restrict__ olens,
                    const int32_t* __restrict__ frow, const int64_t* __restrict__ ffirst,
                    const int32_t* __restrict__ fcount, const int32_t* __restrict__ ulens, int64_t n,
                    uint8_t* __restrict__ comp, int64_t cap, int64_t* __restrict__ cstarts,
                    int32_t* __restrict__ clens) {
  __shared__ int64_t red[kThreads];
  __shared__ int64_t item_at[kItems];    // the item's start in comp
  __shared__ int64_t item_len[kItems];   // its bytes
  __shared__ int64_t item_page[kItems];  // its page
  __shared__ int64_t item_frag[kItems];  // its fragment, -1 for a header
  __shared__ int64_t ctl[3];             // the block's page, headers and fragments before it
  const int tid = threadIdx.x;
  const int64_t last_count = fcount[n - 1];
  const int64_t items = n + ffirst[n - 1] + (last_count > 0 ? last_count : 0);
  const int64_t i0 = int64_t(blockIdx.x) * kItems;
  if (i0 >= items) return;

  // 1. Where the block's items start: the headers and fragments before its
  // first item, summed by all threads.
  if (tid == 0) {
    const int64_t p0 = page_of(ffirst, n, i0);
    const int64_t heads = p0 + (p0 + ffirst[p0] < i0 ? 1 : 0);
    ctl[0] = p0;
    ctl[1] = heads;
    ctl[2] = i0 - heads;
  }
  __syncthreads();
  const int64_t heads = ctl[1], frags_before = ctl[2];
  int64_t part = 0;
  for (int64_t q = tid; q < heads; q += kThreads) part += header_bytes(fcount, ulens, q);
  for (int64_t f = tid; f < frags_before; f += kThreads) part += fragment_bytes(olens, frow, f);
  red[tid] = part;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] += red[tid + s];
    __syncthreads();
  }

  // 2. The block's items, laid out by thread 0.
  const int count = int(items - i0 < kItems ? items - i0 : kItems);
  if (tid == 0) {
    int64_t p = ctl[0], at = red[0];
    for (int k = 0; k < count; ++k) {
      const int64_t i = i0 + k;
      while (p + 1 < n && p + 1 + ffirst[p + 1] <= i) ++p;
      const int64_t head = p + ffirst[p];
      item_page[k] = p;
      item_at[k] = at;
      if (i == head) {
        item_frag[k] = -1;
        item_len[k] = header_bytes(fcount, ulens, p);
      } else {
        item_frag[k] = ffirst[p] + (i - head - 1);
        item_len[k] = fragment_bytes(olens, frow, item_frag[k]);
      }
      at += item_len[k];
    }
  }
  __syncthreads();

  // 3. The items: a fragment's stream copied by the block where it fits in
  // comp; a header, its page's start and length by thread 0.
  for (int k = 0; k < count; ++k) {
    const int64_t at = item_at[k], len = item_len[k], f = item_frag[k];
    if (f >= 0) {
      if (at + len <= cap) {
        const uint8_t* src = frags + int64_t(frow[f]) * frag_w;
        for (int64_t j = tid; j < len; j += kThreads) comp[at + j] = src[j];
      }
    } else if (tid == 0) {
      const int64_t p = item_page[k];
      const int32_t fc = fcount[p];
      int64_t total = len;
      bool ok = fc >= 0;
      for (int64_t g = ffirst[p]; g < ffirst[p] + fc; ++g) {
        const int32_t m = olens[frow[g]];
        ok = ok && m >= 0;
        total += m > 0 ? m : 0;
      }
      if (fc >= 0 && at + len <= cap) {
        uint32_t v = uint32_t(ulens[p]);
        for (int64_t j = 0; j < len; ++j, v >>= 7) comp[at + j] = uint8_t((v & 0x7F) | (j + 1 < len ? 0x80 : 0));
      }
      cstarts[p] = at;
      clens[p] = ok && at + total <= cap ? int32_t(total) : -1;
    }
  }
}

}  // namespace

extern "C" {

// Join the n pages' streams on `stream`: one block a kItems items of the
// (at most n + frag_cap) items, frag_cap the fragment table's rows. Returns
// the cudaError_t of the launch (0 on success); does not synchronise.
int snappy_cuda_join_streams(const void* frags, int64_t frag_w, const void* olens, const void* frow,
                             const void* ffirst, const void* fcount, const void* ulens, int64_t n,
                             int64_t frag_cap, void* comp, int64_t cap, void* cstarts, void* clens,
                             void* stream) {
  if (n <= 0) return cudaSuccess;
  const int64_t blocks = (n + frag_cap + kItems - 1) / kItems;
  join_streams_kernel<<<dim3(unsigned(blocks)), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(frags), frag_w, static_cast<const int32_t*>(olens),
      static_cast<const int32_t*>(frow), static_cast<const int64_t*>(ffirst), static_cast<const int32_t*>(fcount),
      static_cast<const int32_t*>(ulens), n, static_cast<uint8_t*>(comp), cap, static_cast<int64_t*>(cstarts),
      static_cast<int32_t*>(clens));
  return cudaGetLastError();
}

}  // extern "C"
