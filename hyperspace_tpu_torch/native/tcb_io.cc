// Native IO runtime for hyperspace_tpu: parallel columnar buffer loading.
//
// The reference delegates scan IO to Spark's executor pool (file/partition
// task parallelism, SURVEY.md §2.0); here the equivalent is a small C++
// thread pool that preads many TCB column buffers concurrently into
// caller-owned (numpy) memory, releasing Python entirely during the IO.
// Exposed as a plain C ABI consumed via ctypes (hyperspace_tpu/native).
//
// Build: g++ -O3 -march=native -shared -fPIC -pthread tcb_io.cc -o libtcb_io.so

#include <algorithm>
#include <atomic>
#include <cerrno>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fcntl.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct LoadTask {
  const char *path;
  int64_t offset;
  int64_t nbytes;
  void *dest;
};

// pread the byte range [offset, offset+nbytes) of path into dest.
// Returns 0 on success, errno on failure.
int load_one(const LoadTask &t) {
  int fd = ::open(t.path, O_RDONLY);
  if (fd < 0)
    return errno ? errno : -1;
  int64_t done = 0;
  int rc = 0;
  while (done < t.nbytes) {
    ssize_t got = ::pread(fd, static_cast<char *>(t.dest) + done,
                          static_cast<size_t>(t.nbytes - done),
                          static_cast<off_t>(t.offset + done));
    if (got < 0) {
      if (errno == EINTR)
        continue;
      rc = errno ? errno : -1;
      break;
    }
    if (got == 0) { // truncated file
      rc = -2;
      break;
    }
    done += got;
  }
  ::close(fd);
  return rc;
}

} // namespace

extern "C" {

// Load n byte ranges concurrently with up to n_threads workers.
// statuses[i] receives 0 on success, errno / -2 (truncation) otherwise.
// Returns the number of failed tasks.
int hs_pread_many(const char **paths, const int64_t *offsets,
                  const int64_t *nbytes, void **dests, int32_t n,
                  int32_t n_threads, int32_t *statuses) {
  if (n <= 0)
    return 0;
  std::vector<LoadTask> tasks(static_cast<size_t>(n));
  for (int32_t i = 0; i < n; ++i)
    tasks[static_cast<size_t>(i)] = {paths[i], offsets[i], nbytes[i], dests[i]};

  int32_t workers = n_threads;
  int32_t hw = static_cast<int32_t>(std::thread::hardware_concurrency());
  if (workers <= 0)
    workers = hw > 0 ? hw : 4;
  if (hw > 0 && workers > hw)
    workers = hw; // oversubscription only adds contention
  if (workers > n)
    workers = n;

  std::atomic<int32_t> next(0);
  std::atomic<int32_t> failures(0);
  auto body = [&]() {
    for (;;) {
      int32_t i = next.fetch_add(1);
      if (i >= n)
        return;
      int rc = load_one(tasks[static_cast<size_t>(i)]);
      statuses[i] = rc;
      if (rc != 0)
        failures.fetch_add(1);
    }
  };
  if (workers <= 1) {
    body();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(static_cast<size_t>(workers));
    for (int32_t w = 0; w < workers; ++w)
      pool.emplace_back(body);
    for (auto &t : pool)
      t.join();
  }
  return failures.load();
}

// ---------------------------------------------------------------------------
// Segmented sort-merge join (the exchange-free SMJ's merge step).
//
// Both sides hold int64 join codes grouped into aligned segments (buckets):
// segment k of the left joins only segment k of the right, and both are
// ascending within each segment (the on-disk index order). A two-pointer
// walk per segment emits, for every left row, the [lo, lo+cnt) run of
// matching GLOBAL right positions — O(n+m) total instead of the
// O(n log m) of per-row binary search, parallel across segments, GIL
// released for the whole call.
// ---------------------------------------------------------------------------

// Phase A: per-left-row match ranges. Returns total match count.
int64_t hs_smj_ranges(const int64_t *l, const int64_t *r, const int64_t *lb,
                      const int64_t *rb, int32_t n_seg, int64_t *lo,
                      int64_t *cnt, int32_t n_threads) {
  std::atomic<int32_t> next_seg(0);
  std::vector<int64_t> seg_totals(static_cast<size_t>(n_seg), 0);
  auto body = [&]() {
    for (;;) {
      int32_t k = next_seg.fetch_add(1);
      if (k >= n_seg)
        return;
      int64_t i = lb[k], le = lb[k + 1];
      int64_t j = rb[k], re = rb[k + 1];
      int64_t total = 0;
      while (i < le) {
        const int64_t v = l[i];
        while (j < re && r[j] < v)
          ++j;
        int64_t jr = j;
        while (jr < re && r[jr] == v)
          ++jr;
        const int64_t run = jr - j;
        while (i < le && l[i] == v) {
          lo[i] = j;
          cnt[i] = run;
          total += run;
          ++i;
        }
      }
      seg_totals[static_cast<size_t>(k)] = total;
    }
  };
  int32_t hw = static_cast<int32_t>(std::thread::hardware_concurrency());
  int32_t workers = n_threads > 0 ? n_threads : (hw > 0 ? hw : 4);
  if (workers > n_seg)
    workers = n_seg;
  if (workers <= 1) {
    body();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(static_cast<size_t>(workers));
    for (int32_t w = 0; w < workers; ++w)
      pool.emplace_back(body);
    for (auto &t : pool)
      t.join();
  }
  int64_t total = 0;
  for (int64_t s : seg_totals)
    total += s;
  return total;
}

// Phase B: expand ranges into (l_idx, r_idx) pair arrays. off[i] is the
// exclusive prefix sum of cnt (the caller computes it once; off[n_l] =
// total). Parallel over left-row chunks — each row's writes are disjoint.
void hs_expand_pairs(const int64_t *lo, const int64_t *cnt, const int64_t *off,
                     int64_t n_l, int64_t *l_idx, int64_t *r_idx,
                     int32_t n_threads) {
  int32_t hw = static_cast<int32_t>(std::thread::hardware_concurrency());
  int32_t workers = n_threads > 0 ? n_threads : (hw > 0 ? hw : 4);
  if (workers < 1)
    workers = 1;
  const int64_t chunk = (n_l + workers - 1) / workers;
  auto body = [&](int64_t begin, int64_t end) {
    for (int64_t i = begin; i < end; ++i) {
      int64_t w = off[i];
      const int64_t base = lo[i];
      for (int64_t c = 0; c < cnt[i]; ++c, ++w) {
        l_idx[w] = i;
        r_idx[w] = base + c;
      }
    }
  };
  if (workers <= 1 || n_l < (1 << 16)) {
    body(0, n_l);
  } else {
    std::vector<std::thread> pool;
    for (int32_t w = 0; w < workers; ++w) {
      int64_t b = w * chunk, e = std::min(n_l, b + chunk);
      if (b >= e)
        break;
      pool.emplace_back(body, b, e);
    }
    for (auto &t : pool)
      t.join();
  }
}

// Phase B fused with the output gather: expand ranges and write the
// joined output columns directly — the (l_idx, r_idx) arrays (16 bytes
// per output pair, written then immediately re-read by numpy gathers)
// never exist. Columns are 4- or 8-byte fixed-width raw buffers (int32
// codes / int64 / float as bits). Parallel over left-row chunks: each
// row's output slots are disjoint.
namespace {
inline void copy_elem(void *dst, const void *src, int64_t di, int64_t si,
                      int32_t w) {
  if (w == 8)
    static_cast<int64_t *>(dst)[di] = static_cast<const int64_t *>(src)[si];
  else
    static_cast<int32_t *>(dst)[di] = static_cast<const int32_t *>(src)[si];
}
} // namespace

void hs_expand_gather(const int64_t *lo, const int64_t *cnt,
                      const int64_t *off, int64_t n_l, const void **l_srcs,
                      const int32_t *l_widths, int32_t n_lcols,
                      const void **r_srcs, const int32_t *r_widths,
                      int32_t n_rcols, void **l_dsts, void **r_dsts,
                      int32_t n_threads) {
  int32_t hw = static_cast<int32_t>(std::thread::hardware_concurrency());
  int32_t workers = n_threads > 0 ? n_threads : (hw > 0 ? hw : 4);
  if (workers < 1)
    workers = 1;
  const int64_t total = off[n_l];
  auto body = [&](int64_t begin, int64_t end) {
    for (int64_t i = begin; i < end; ++i) {
      int64_t w = off[i];
      const int64_t base = lo[i];
      for (int64_t c = 0; c < cnt[i]; ++c, ++w) {
        for (int32_t k = 0; k < n_lcols; ++k)
          copy_elem(l_dsts[k], l_srcs[k], w, i, l_widths[k]);
        for (int32_t k = 0; k < n_rcols; ++k)
          copy_elem(r_dsts[k], r_srcs[k], w, base + c, r_widths[k]);
      }
    }
  };
  if (workers <= 1 || total < (1 << 16)) {
    body(0, n_l);
  } else {
    // partition by OUTPUT position, not left-row count: a hot key whose
    // matches dominate the output would otherwise land on one thread
    std::vector<std::thread> pool;
    int64_t prev_row = 0;
    for (int32_t t = 0; t < workers && prev_row < n_l; ++t) {
      const int64_t target = (total * (t + 1)) / workers;
      int64_t row_end =
          (t == workers - 1)
              ? n_l
              : std::upper_bound(off, off + n_l + 1, target) - off - 1;
      if (row_end <= prev_row)
        continue;
      pool.emplace_back(body, prev_row, row_end);
      prev_row = row_end;
    }
    if (prev_row < n_l)
      pool.emplace_back(body, prev_row, n_l);
    for (auto &t : pool)
      t.join();
  }
}

// ---------------------------------------------------------------------------
// Fused group-by aggregate over SMJ match ranges (the Q17 hot path).
//
// One pass over the left rows accumulates, into dense per-group slots
// (group keys pre-offset by the caller to 0..span), the join's row count
// and the sum / non-NULL count of ONE right-side value column read
// straight through the match ranges — the pair expansion, the 16-byte-
// per-pair index traffic, the joined-batch gathers, and the separate
// factorize+bincount passes of the materialized path all disappear.
// Sequential by design: the scatter targets shared slots, and the whole
// pass is memory-bound on one stream.
// ---------------------------------------------------------------------------
// The scatter into per-group slots is the pass's wall: three separate
// span-sized arrays cost three cache misses per left row. One interleaved
// 24-byte slot {sum, nn, rows} keeps a group's whole accumulator on one
// cache line — measured ~2x on the 200k-group Q17 shape — and is copied
// out to the caller's arrays once at the end.
namespace {
struct AggSlot {
  double sum;
  int64_t nn;
  int64_t rows;
};
struct AggSlotI {
  int64_t sum;
  int64_t nn;
  int64_t rows;
};
} // namespace

void hs_group_agg_ranges_f64(const int64_t *keys, const int64_t *lo,
                             const int64_t *cnt, int64_t n_l,
                             const double *r_vals, double *sums, int64_t *nn,
                             int64_t *rows) {
  int64_t span = 0;
  for (int64_t i = 0; i < n_l; ++i)
    span = std::max(span, keys[i] + 1);
  std::vector<AggSlot> acc(static_cast<size_t>(span), AggSlot{0.0, 0, 0});
  for (int64_t i = 0; i < n_l; ++i) {
    AggSlot &s = acc[static_cast<size_t>(keys[i])];
    const int64_t c = cnt[i];
    s.rows += c;
    const int64_t b = lo[i], e = b + c;
    for (int64_t j = b; j < e; ++j) {
      const double v = r_vals[j];
      if (!std::isnan(v)) {
        s.sum += v;
        s.nn += 1;
      }
    }
  }
  for (int64_t k = 0; k < span; ++k) {
    sums[k] = acc[static_cast<size_t>(k)].sum;
    nn[k] = acc[static_cast<size_t>(k)].nn;
    rows[k] = acc[static_cast<size_t>(k)].rows;
  }
}

// int64 variant: exact (wraparound is modular and cancels nowhere — the
// true sum either fits int64 or the caller's bound guard routed away).
// Integers have no NULL, so nn == rows contribution per match.
void hs_group_agg_ranges_i64(const int64_t *keys, const int64_t *lo,
                             const int64_t *cnt, int64_t n_l,
                             const int64_t *r_vals, int64_t *sums, int64_t *nn,
                             int64_t *rows) {
  int64_t span = 0;
  for (int64_t i = 0; i < n_l; ++i)
    span = std::max(span, keys[i] + 1);
  std::vector<AggSlotI> acc(static_cast<size_t>(span), AggSlotI{0, 0, 0});
  for (int64_t i = 0; i < n_l; ++i) {
    AggSlotI &s = acc[static_cast<size_t>(keys[i])];
    const int64_t c = cnt[i];
    s.rows += c;
    const int64_t b = lo[i], e = b + c;
    for (int64_t j = b; j < e; ++j) {
      s.sum += r_vals[j];
      s.nn += 1;
    }
  }
  for (int64_t k = 0; k < span; ++k) {
    sums[k] = acc[static_cast<size_t>(k)].sum;
    nn[k] = acc[static_cast<size_t>(k)].nn;
    rows[k] = acc[static_cast<size_t>(k)].rows;
  }
}

// Durable single-buffer write: write tmp_path, fsync, rename() to path.
// Returns 0 on success, errno otherwise. (The operation-log claim itself
// stays in Python — link(2) semantics there are part of the OCC protocol;
// this is for bulk index data.)
int hs_write_file_atomic(const char *tmp_path, const char *path,
                         const void *data, int64_t nbytes) {
  int fd = ::open(tmp_path, O_WRONLY | O_CREAT | O_TRUNC, 0644);
  if (fd < 0)
    return errno ? errno : -1;
  int64_t done = 0;
  while (done < nbytes) {
    ssize_t put = ::write(fd, static_cast<const char *>(data) + done,
                          static_cast<size_t>(nbytes - done));
    if (put < 0) {
      if (errno == EINTR)
        continue;
      int rc = errno;
      ::close(fd);
      return rc ? rc : -1;
    }
    done += put;
  }
  if (::fsync(fd) != 0) {
    int rc = errno;
    ::close(fd);
    return rc ? rc : -1;
  }
  ::close(fd);
  if (std::rename(tmp_path, path) != 0)
    return errno ? errno : -1;
  return 0;
}

} // extern "C"
