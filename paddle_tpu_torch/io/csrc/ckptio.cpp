// Native checkpoint chunk writer.
//
// Parity: the reference's checkpoint save path runs in C++ (tensor
// serialization in paddle/fluid/framework + async save executors). The
// checkpoint layout is many independent .npy chunk files, and a Python
// disk phase would be a serial, GIL-bound loop of writes. This library
// writes a BATCH of (header, data) pairs to files from a thread pool —
// each file is open/write/fsync on its own thread, so large sharded
// checkpoints hit the filesystem in parallel.
//
// C ABI (consumed via ctypes from distributed/checkpoint.py):
//   ptck_write_batch(n, paths[], headers[], header_lens[],
//                    datas[], data_lens[], nthreads, do_fsync)
//     -> 0 on success, else the number of files that failed to write.

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

bool write_all(int fd, const uint8_t* buf, int64_t len) {
  int64_t off = 0;
  while (off < len) {
    ssize_t w = write(fd, buf + off, static_cast<size_t>(len - off));
    if (w < 0) {
      if (errno == EINTR) continue;
      return false;
    }
    off += w;
  }
  return true;
}

bool write_one(const char* path, const uint8_t* header, int64_t header_len,
               const uint8_t* data, int64_t data_len, bool do_fsync) {
  int fd = open(path, O_WRONLY | O_CREAT | O_TRUNC, 0644);
  if (fd < 0) return false;
  bool ok = write_all(fd, header, header_len) &&
            (data_len == 0 || write_all(fd, data, data_len));
  if (ok && do_fsync) ok = fsync(fd) == 0;
  close(fd);
  return ok;
}

}  // namespace

extern "C" {

// Returns the number of failed files (0 = all written).
int ptck_write_batch(int n, const char** paths, const uint8_t** headers,
                     const int64_t* header_lens, const uint8_t** datas,
                     const int64_t* data_lens, int nthreads, int do_fsync) {
  if (n <= 0) return 0;
  std::atomic<int> next{0};
  std::atomic<int> failures{0};
  int nt = nthreads > 0 ? nthreads : 4;
  if (nt > n) nt = n;
  std::vector<std::thread> workers;
  workers.reserve(nt);
  for (int w = 0; w < nt; ++w) {
    workers.emplace_back([&] {
      for (;;) {
        int i = next.fetch_add(1);
        if (i >= n) return;
        if (!write_one(paths[i], headers[i], header_lens[i], datas[i],
                       data_lens[i], do_fsync != 0))
          failures.fetch_add(1);
      }
    });
  }
  for (auto& t : workers) t.join();
  return failures.load();
}

}  // extern "C"
