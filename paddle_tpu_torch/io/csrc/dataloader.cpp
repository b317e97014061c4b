// Native data-loading core.
//
// Parity: the reference's C++ DataLoader machinery (multiprocess workers,
// pinned-memory H2D pipeline, python/paddle/io/ + paddle/fluid/operators/
// reader/) — the part of the framework where Python in the per-step loop
// actually costs throughput.
//
// Shape of the problem: pretraining reads fixed-length token
// sequences from large binary shards. This library mmaps token-bin files
// (uint16 or uint32 tokens), draws deterministic per-epoch shuffled
// sequence indices, and materializes batches into caller-provided int32
// buffers from a background prefetch thread pool, so the Python side only
// does a queue pop and a copy to the device.
//
// C ABI (consumed via ctypes from io/native.py):
//   ptdl_open(path, token_bytes, seq_len)            -> handle (>=0) | -errno
//   ptdl_num_seqs(handle)                            -> int64
//   ptdl_start_epoch(handle, seed, batch, drop_last, shuffle, nthreads)
//   ptdl_next_batch(handle, out_int32, out_indices)  -> n_filled (0 = end)
//   ptdl_close(handle)

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <fcntl.h>
#include <memory>
#include <map>
#include <mutex>
#include <numeric>
#include <random>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct Batch {
  std::vector<int32_t> tokens;
  std::vector<int64_t> indices;
  int64_t n = 0;
};

struct Dataset {
  int fd = -1;
  const uint8_t* data = nullptr;
  size_t bytes = 0;
  int token_bytes = 2;
  int64_t seq_len = 0;
  int64_t num_seqs = 0;

  // epoch state
  std::vector<int64_t> order;
  std::atomic<int64_t> next_index{0};
  int64_t batch_size = 1;
  bool drop_last = true;
  int64_t epoch_batches = 0;

  // prefetch machinery. Batches are delivered IN INDEX ORDER: workers
  // complete out of order under load, so a plain FIFO queue makes the
  // epoch's batch sequence scheduling-dependent (breaks same-seed
  // determinism); the ready-map + next_deliver cursor restores it.
  std::vector<std::thread> workers;
  std::map<int64_t, Batch> ready;
  int64_t next_deliver = 0;
  std::mutex mu;
  std::condition_variable cv_push, cv_pop;
  size_t max_queue = 8;
  std::atomic<bool> stopping{false};

  ~Dataset() { shutdown(); }

  void shutdown() {
    {
      // store+notify under mu: a lock-free store can land between a
      // waiter's predicate check and its block, losing the wakeup
      std::lock_guard<std::mutex> g(mu);
      stopping.store(true);
    }
    cv_push.notify_all();
    cv_pop.notify_all();
    for (auto& t : workers)
      if (t.joinable()) t.join();
    workers.clear();
    {
      std::lock_guard<std::mutex> g(mu);
      ready.clear();
    }
    if (data) {
      munmap(const_cast<uint8_t*>(data), bytes);
      data = nullptr;
    }
    if (fd >= 0) {
      close(fd);
      fd = -1;
    }
  }

  inline int32_t token_at(int64_t flat) const {
    if (token_bytes == 2) {
      uint16_t v;
      std::memcpy(&v, data + flat * 2, 2);
      return static_cast<int32_t>(v);
    }
    int32_t v;
    std::memcpy(&v, data + flat * 4, 4);
    return v;
  }

  void fill(Batch& b, int64_t batch_start) {
    int64_t remaining = static_cast<int64_t>(order.size()) - batch_start;
    int64_t n = remaining < batch_size ? remaining : batch_size;
    b.n = n;
    b.tokens.resize(static_cast<size_t>(n) * seq_len);
    b.indices.resize(n);
    for (int64_t i = 0; i < n; ++i) {
      int64_t seq = order[batch_start + i];
      b.indices[i] = seq;
      int64_t base = seq * seq_len;
      int32_t* out = b.tokens.data() + i * seq_len;
      for (int64_t t = 0; t < seq_len; ++t) out[t] = token_at(base + t);
    }
  }

  void worker_loop() {
    while (!stopping.load()) {
      int64_t bi = next_index.fetch_add(1);
      if (bi >= epoch_batches) return;
      Batch b;
      fill(b, bi * batch_size);
      std::unique_lock<std::mutex> lk(mu);
      // bounded lookahead relative to the delivery cursor — the batch
      // the consumer needs next (bi == next_deliver) is never blocked,
      // so this cannot deadlock
      cv_push.wait(lk, [&] {
        return stopping.load() ||
               bi < next_deliver + static_cast<int64_t>(max_queue);
      });
      if (stopping.load()) return;
      ready.emplace(bi, std::move(b));
      cv_pop.notify_all();
    }
  }
};

std::mutex g_mu;
std::vector<std::unique_ptr<Dataset>> g_handles;

Dataset* get(int h) {
  std::lock_guard<std::mutex> g(g_mu);
  if (h < 0 || h >= static_cast<int>(g_handles.size())) return nullptr;
  return g_handles[h].get();
}

}  // namespace

extern "C" {

int ptdl_open(const char* path, int token_bytes, int64_t seq_len) {
  if (token_bytes != 2 && token_bytes != 4) return -1;
  if (seq_len <= 0) return -1;
  auto ds = std::make_unique<Dataset>();
  ds->fd = open(path, O_RDONLY);
  if (ds->fd < 0) return -2;
  struct stat st;
  if (fstat(ds->fd, &st) != 0) return -3;
  ds->bytes = static_cast<size_t>(st.st_size);
  ds->token_bytes = token_bytes;
  ds->seq_len = seq_len;
  ds->num_seqs = static_cast<int64_t>(ds->bytes) / (token_bytes * seq_len);
  if (ds->num_seqs == 0) return -4;
  void* p = mmap(nullptr, ds->bytes, PROT_READ, MAP_PRIVATE, ds->fd, 0);
  if (p == MAP_FAILED) return -5;
  madvise(p, ds->bytes, MADV_WILLNEED);
  ds->data = static_cast<const uint8_t*>(p);
  std::lock_guard<std::mutex> g(g_mu);
  g_handles.push_back(std::move(ds));
  return static_cast<int>(g_handles.size()) - 1;
}

int64_t ptdl_num_seqs(int h) {
  Dataset* ds = get(h);
  return ds ? ds->num_seqs : -1;
}

int ptdl_start_epoch(int h, int64_t seed, int64_t batch_size, int drop_last,
                     int shuffle, int nthreads) {
  Dataset* ds = get(h);
  if (!ds || batch_size <= 0) return -1;
  // stop any previous epoch's workers (store under mu — see shutdown)
  {
    std::lock_guard<std::mutex> g(ds->mu);
    ds->stopping.store(true);
  }
  ds->cv_push.notify_all();
  ds->cv_pop.notify_all();
  for (auto& t : ds->workers)
    if (t.joinable()) t.join();
  ds->workers.clear();
  {
    std::lock_guard<std::mutex> g(ds->mu);
    ds->ready.clear();
    ds->next_deliver = 0;
  }
  ds->stopping.store(false);

  ds->order.resize(ds->num_seqs);
  std::iota(ds->order.begin(), ds->order.end(), 0);
  if (shuffle) {
    std::mt19937_64 rng(static_cast<uint64_t>(seed));
    std::shuffle(ds->order.begin(), ds->order.end(), rng);
  }
  ds->batch_size = batch_size;
  ds->drop_last = drop_last != 0;
  ds->epoch_batches = ds->drop_last
                          ? ds->num_seqs / batch_size
                          : (ds->num_seqs + batch_size - 1) / batch_size;
  ds->next_index.store(0);
  int n = nthreads > 0 ? nthreads : 2;
  for (int i = 0; i < n; ++i)
    ds->workers.emplace_back([ds] { ds->worker_loop(); });
  return 0;
}

// out must hold batch_size*seq_len int32; out_indices batch_size int64.
// returns rows filled; 0 when the epoch is exhausted; <0 on error.
int64_t ptdl_next_batch(int h, int32_t* out, int64_t* out_indices) {
  Dataset* ds = get(h);
  if (!ds) return -1;
  std::unique_lock<std::mutex> lk(ds->mu);
  Batch b;
  for (;;) {
    if (ds->next_deliver >= ds->epoch_batches) return 0;  // exhausted
    const int64_t want = ds->next_deliver;
    // multi-consumer safe: a second caller waiting on the same index
    // wakes when the cursor moves past it and retries on the new head
    ds->cv_pop.wait(lk, [&] {
      return ds->stopping.load() || ds->ready.count(want) != 0 ||
             ds->next_deliver != want;
    });
    if (ds->stopping.load() && ds->ready.count(want) == 0) return 0;
    if (ds->next_deliver != want) continue;  // lost the race; retry
    auto it = ds->ready.find(want);
    b = std::move(it->second);
    ds->ready.erase(it);
    ds->next_deliver = want + 1;
    break;
  }
  ds->cv_push.notify_all();
  ds->cv_pop.notify_all();
  lk.unlock();
  std::memcpy(out, b.tokens.data(), b.tokens.size() * sizeof(int32_t));
  if (out_indices)
    std::memcpy(out_indices, b.indices.data(),
                b.indices.size() * sizeof(int64_t));
  return b.n;
}

int ptdl_close(int h) {
  std::lock_guard<std::mutex> g(g_mu);
  if (h < 0 || h >= static_cast<int>(g_handles.size()) || !g_handles[h])
    return -1;
  g_handles[h].reset();
  return 0;
}

}  // extern "C"
