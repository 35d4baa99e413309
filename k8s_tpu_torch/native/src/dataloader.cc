// Native data loader: threaded pread() over registered files with an
// ordered slot ring.
//
// Role: the input-pipeline stage of the runtime (the reference delegates
// this to TensorFlow's C++ tf.data machinery; here the Python token-shard
// dataset (k8s_tpu_torch/models/dataset.py) submits (file, offset, length)
// window descriptors and consumes them in submission order).  Python's
// mmap path page-faults while HOLDING the GIL, so a training step and its
// input pipeline serialize; these reads happen on C++ threads with no GIL
// anywhere near them.
//
// Ordering contract: windows are delivered in submission order.  The
// caller bounds in-flight submissions to the slot count (dl_submit returns
// 0 when the ring is full), which guarantees slot seq % n_slots is free by
// the time its descriptor is admitted.
//
// Plain C ABI over ctypes (k8s_tpu_torch/native/__init__.py declares it).
// The port's own copy of k8s_tpu/native/src/dataloader.cc.

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <unistd.h>

#include "tsan_wait.h"

namespace {

struct Desc {
  uint64_t seq;
  int file_id;
  uint64_t offset;
  uint64_t nbytes;
};

struct Slot {
  std::vector<char> buf;
  uint64_t nbytes = 0;
  // 0 = empty, 1 = ready
  std::atomic<int> ready{0};
};

struct Loader {
  std::mutex mu;
  std::condition_variable work_cv;   // readers wait for descriptors
  std::condition_variable ready_cv;  // consumer waits for its slot
  std::vector<int> fds;
  std::vector<Slot> slots;
  std::deque<Desc> pending;
  std::vector<std::thread> threads;
  uint64_t submit_seq = 0;
  uint64_t consume_seq = 0;
  bool stopping = false;
  std::atomic<bool> error{false};

  explicit Loader(int n_slots, uint64_t max_item_bytes, int n_threads)
      : slots(n_slots) {
    for (auto& s : slots) s.buf.resize(max_item_bytes);
    for (int i = 0; i < n_threads; i++) {
      threads.emplace_back([this] { this->reader_loop(); });
    }
  }

  ~Loader() {
    {
      std::lock_guard<std::mutex> lock(mu);
      stopping = true;
    }
    work_cv.notify_all();
    ready_cv.notify_all();
    for (auto& t : threads) t.join();
    for (int fd : fds) {
      if (fd >= 0) ::close(fd);
    }
  }

  void reader_loop() {
    for (;;) {
      Desc d;
      int fd = -1;
      {
        std::unique_lock<std::mutex> lock(mu);
        work_cv.wait(lock, [this] { return stopping || !pending.empty(); });
        if (stopping) return;
        d = pending.front();
        pending.pop_front();
        // copy the fd under mu: dl_register_file may reallocate the vector
        if (d.file_id >= 0 && d.file_id < (int)fds.size()) fd = fds[d.file_id];
      }
      Slot& slot = slots[d.seq % slots.size()];
      uint64_t got = 0;
      if (fd < 0 || d.nbytes > slot.buf.size()) {
        error.store(true);
      } else {
        while (got < d.nbytes) {
          ssize_t n = ::pread(fd, slot.buf.data() + got, d.nbytes - got,
                              (off_t)(d.offset + got));
          if (n <= 0) {  // EOF mid-window or IO error: poison the loader
            error.store(true);
            break;
          }
          got += (uint64_t)n;
        }
      }
      slot.nbytes = got;
      {
        // publish under mu: a lock-free store+notify can slip between the
        // consumer's predicate check and its block (lost wakeup), stalling
        // dl_next for its whole timeout
        std::lock_guard<std::mutex> lock(mu);
        slot.ready.store(1, std::memory_order_release);
      }
      ready_cv.notify_all();
    }
  }
};

}  // namespace

extern "C" {

void* dl_new(int n_slots, uint64_t max_item_bytes, int n_threads) {
  if (n_slots < 1 || max_item_bytes == 0 || n_threads < 1) return nullptr;
  return new Loader(n_slots, max_item_bytes, n_threads);
}

void dl_free(void* h) { delete static_cast<Loader*>(h); }

// Returns a file id, or -1 on open failure.
int dl_register_file(void* h, const char* path) {
  Loader* L = static_cast<Loader*>(h);
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return -1;
  std::lock_guard<std::mutex> lock(L->mu);
  L->fds.push_back(fd);
  return (int)L->fds.size() - 1;
}

// Returns 1 when accepted, 0 when the ring is full (caller must consume
// first), -1 when the loader is stopped/poisoned.
int dl_submit(void* h, int file_id, uint64_t offset, uint64_t nbytes) {
  Loader* L = static_cast<Loader*>(h);
  if (L->error.load()) return -1;
  {
    std::lock_guard<std::mutex> lock(L->mu);
    if (L->stopping) return -1;
    if (L->submit_seq - L->consume_seq >= L->slots.size()) return 0;
    L->pending.push_back(Desc{L->submit_seq, file_id, offset, nbytes});
    L->submit_seq++;
  }
  L->work_cv.notify_one();
  return 1;
}

// Copies the next window (submission order) into out.  Returns the byte
// count, 0 on timeout, -1 on error/stop, -2 when nothing is in flight.
int64_t dl_next(void* h, char* out, uint64_t out_cap, int timeout_ms) {
  Loader* L = static_cast<Loader*>(h);
  uint64_t seq;
  {
    std::lock_guard<std::mutex> lock(L->mu);
    if (L->consume_seq == L->submit_seq) return -2;
    seq = L->consume_seq;
  }
  Slot& slot = L->slots[seq % L->slots.size()];
  {
    std::unique_lock<std::mutex> lock(L->mu);
    bool ok = tsan_safe_wait_for(
        L->ready_cv, lock, std::chrono::milliseconds(timeout_ms), [&] {
          return L->stopping || L->error.load() ||
                 slot.ready.load(std::memory_order_acquire) != 0;
        });
    if (!ok) return 0;  // timeout
    if (L->stopping) return -1;
  }
  // Any read failure poisons the whole loader: a training input stream
  // with a silently skipped or truncated window is worse than a crash.
  if (L->error.load()) return -1;
  uint64_t n = slot.nbytes;
  if (n > out_cap) return -1;
  std::memcpy(out, slot.buf.data(), n);
  slot.ready.store(0, std::memory_order_release);
  {
    std::lock_guard<std::mutex> lock(L->mu);
    L->consume_seq++;
  }
  return (int64_t)n;
}

int dl_error(void* h) { return static_cast<Loader*>(h)->error.load() ? 1 : 0; }

uint64_t dl_inflight(void* h) {
  Loader* L = static_cast<Loader*>(h);
  std::lock_guard<std::mutex> lock(L->mu);
  return L->submit_seq - L->consume_seq;
}

}  // extern "C"
