// hostio: multithreaded host-side tensor<->file IO and buffer packing,
// the port's own copy of the JAX package's native engine (the same C
// ABI, function for function).
//
//   * the reference's apex/contrib/csrc/gpu_direct_storage/gds.cpp
//     (cuFile save/load of tensor bytes) -> offset-based parallel
//     pread/pwrite of host buffers; a card tensor reaches them through
//     one pinned host staging buffer (apex_tpu_torch/ops/hostio.py);
//   * csrc/flatten_unflatten.cpp (apex_C: bucket flatten/unflatten) ->
//     parallel gather/scatter memcpy between many host buffers and one
//     contiguous arena.
//
// Plain C ABI, loaded with ctypes and built with g++ at first use into
// apex_tpu_torch/build/ (apex_tpu_torch/_build.py). All functions return
// 0 on success or -errno on failure; chunk work is sliced across up to
// `threads` std::threads.

#include <cerrno>
#include <cstdint>
#include <cstring>
#include <atomic>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/stat.h>
#include <sys/types.h>
#include <unistd.h>

namespace {

// Partition [0, n) chunks across workers and run fn(chunk_index) on each;
// collects the first nonzero error code.
template <typename Fn>
int parallel_chunks(int64_t n, int threads, Fn fn) {
  if (n <= 0) return 0;
  int nt = threads < 1 ? 1 : threads;
  if (nt > n) nt = static_cast<int>(n);
  std::atomic<int> err{0};
  std::atomic<int64_t> next{0};
  auto worker = [&]() {
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= n || err.load() != 0) return;
      int e = fn(i);
      if (e != 0) {
        int expected = 0;
        err.compare_exchange_strong(expected, e);
      }
    }
  };
  if (nt == 1) {
    worker();
  } else {
    std::vector<std::thread> ts;
    ts.reserve(nt);
    for (int t = 0; t < nt; ++t) ts.emplace_back(worker);
    for (auto &t : ts) t.join();
  }
  return err.load();
}

int full_pwrite(int fd, const char *buf, int64_t size, int64_t off) {
  while (size > 0) {
    ssize_t w = ::pwrite(fd, buf, static_cast<size_t>(size), off);
    if (w < 0) {
      if (errno == EINTR) continue;
      return -errno;
    }
    buf += w;
    off += w;
    size -= w;
  }
  return 0;
}

int full_pread(int fd, char *buf, int64_t size, int64_t off) {
  while (size > 0) {
    ssize_t r = ::pread(fd, buf, static_cast<size_t>(size), off);
    if (r < 0) {
      if (errno == EINTR) continue;
      return -errno;
    }
    if (r == 0) return -EIO;  // unexpected EOF
    buf += r;
    off += r;
    size -= r;
  }
  return 0;
}

}  // namespace

extern "C" {

// fd-based cores: callers holding a descriptor open (e.g. GDSFile's
// lifetime handle) avoid one open/close pair per call.
int hostio_write_fd(int fd, int64_t n, const int64_t *offsets,
                    const int64_t *sizes, const void *const *ptrs,
                    int threads) {
  return parallel_chunks(n, threads, [&](int64_t i) {
    return full_pwrite(fd, static_cast<const char *>(ptrs[i]), sizes[i],
                       offsets[i]);
  });
}

int hostio_read_fd(int fd, int64_t n, const int64_t *offsets,
                   const int64_t *sizes, void *const *ptrs, int threads) {
  return parallel_chunks(n, threads, [&](int64_t i) {
    return full_pread(fd, static_cast<char *>(ptrs[i]), sizes[i],
                      offsets[i]);
  });
}

// Write n chunks (ptrs[i], sizes[i]) at byte offsets[i] of path. Creates
// the file if needed; never truncates (callers layer their own format).
int hostio_write(const char *path, int64_t n, const int64_t *offsets,
                 const int64_t *sizes, const void *const *ptrs,
                 int threads) {
  int fd = ::open(path, O_WRONLY | O_CREAT, 0644);
  if (fd < 0) return -errno;
  int err = hostio_write_fd(fd, n, offsets, sizes, ptrs, threads);
  if (::close(fd) != 0 && err == 0) err = -errno;
  return err;
}

// Read n chunks into caller-owned buffers ptrs[i] from byte offsets[i].
int hostio_read(const char *path, int64_t n, const int64_t *offsets,
                const int64_t *sizes, void *const *ptrs, int threads) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return -errno;
  int err = hostio_read_fd(fd, n, offsets, sizes, ptrs, threads);
  if (::close(fd) != 0 && err == 0) err = -errno;
  return err;
}

int64_t hostio_file_size(const char *path) {
  struct stat st;
  if (::stat(path, &st) != 0) return -errno;
  return static_cast<int64_t>(st.st_size);
}

// Gather: copy n source buffers into one arena at dst_offsets (flatten).
int hostio_pack(void *dst, int64_t n, const void *const *srcs,
                const int64_t *sizes, const int64_t *dst_offsets,
                int threads) {
  char *base = static_cast<char *>(dst);
  return parallel_chunks(n, threads, [&](int64_t i) {
    std::memcpy(base + dst_offsets[i], srcs[i],
                static_cast<size_t>(sizes[i]));
    return 0;
  });
}

// Scatter: copy slices of one arena out to n destination buffers
// (unflatten).
int hostio_unpack(const void *src, int64_t n, void *const *dsts,
                  const int64_t *sizes, const int64_t *src_offsets,
                  int threads) {
  const char *base = static_cast<const char *>(src);
  return parallel_chunks(n, threads, [&](int64_t i) {
    std::memcpy(dsts[i], base + src_offsets[i],
                static_cast<size_t>(sizes[i]));
    return 0;
  });
}

}  // extern "C"
