// Concurrency stress harness for the window reader (dataloader.cc): the
// loader half of k8s_tpu/native/src/stress_main.cc.  Built twice by the
// tests, plain and with -fsanitize=thread.
//
//     stress_dataloader DIR
//
// writes its scratch file into DIR.  Invariant hammered: windows submitted
// from one thread while another consumes come back in submission order with
// their own bytes, under races between the reader threads, the submitter
// and the consumer, through a ring smaller than the stream.
//
// Exits 0 on success; asserts (SIGABRT) on an invariant violation; under
// TSan, any data race fails the run via halt_on_error=1.

#include "dataloader.cc"

#include <cassert>
#include <cstdio>
#include <cstdlib>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <stdlib.h>
#include <unistd.h>

namespace {

void stress_dataloader(const std::string& dir) {
  // One file of sequential uint32 values; windows submitted from one
  // thread while this thread consumes — ordering and content must hold
  // under races between readers, submitter, and consumer.
  constexpr int kValues = 1 << 16;
  constexpr int kWindow = 256;            // values per window
  constexpr int kWindowBytes = kWindow * 4;
  std::string tmpl = dir + "/k8stpu_dl_stress_XXXXXX";
  std::vector<char> path(tmpl.begin(), tmpl.end());
  path.push_back('\0');
  int fd = mkstemp(path.data());
  assert(fd >= 0);
  {
    std::vector<uint32_t> vals(kValues);
    for (int i = 0; i < kValues; i++) vals[i] = (uint32_t)i;
    ssize_t n = write(fd, vals.data(), vals.size() * 4);
    assert(n == (ssize_t)(vals.size() * 4));
  }
  close(fd);

  void* h = dl_new(/*n_slots=*/8, kWindowBytes, /*n_threads=*/3);
  assert(h != nullptr);
  int fid = dl_register_file(h, path.data());
  assert(fid == 0);

  constexpr int kWindows = kValues / kWindow;
  std::thread submitter([&] {
    for (int w = 0; w < kWindows; w++) {
      for (;;) {
        int rc = dl_submit(h, fid, (uint64_t)w * kWindowBytes, kWindowBytes);
        assert(rc >= 0);
        if (rc == 1) break;
        std::this_thread::yield();  // ring full: consumer will drain
      }
    }
  });

  std::vector<char> buf(kWindowBytes);
  int consumed = 0;
  while (consumed < kWindows) {
    int64_t n = dl_next(h, buf.data(), kWindowBytes, 5000);
    if (n == -2) {  // nothing in flight yet
      std::this_thread::yield();
      continue;
    }
    assert(n == kWindowBytes);
    const uint32_t* vals = reinterpret_cast<const uint32_t*>(buf.data());
    for (int i = 0; i < kWindow; i++) {
      assert(vals[i] == (uint32_t)(consumed * kWindow + i));  // in order
    }
    consumed++;
  }
  assert(dl_error(h) == 0);
  assert(dl_inflight(h) == 0);
  submitter.join();
  dl_free(h);
  unlink(path.data());
  std::printf("dataloader stress OK: %d ordered windows x 3 reader threads\n",
              kWindows);
}

}  // namespace

int main(int argc, char** argv) {
  if (argc != 2) {
    std::fprintf(stderr, "usage: %s DIR\n", argv[0]);
    return 2;
  }
  stress_dataloader(argv[1]);
  std::printf("native dataloader stress PASS\n");
  return 0;
}
