// TSan-safe condition-variable timed waits.
//
// libstdc++ on glibc >= 2.30 implements condition_variable::wait_for (and
// steady-clock wait_until) with pthread_cond_clockwait, which gcc's libtsan
// does not intercept (GCC PR sanitizer/98712).  TSan then misses the unlock
// performed inside the wait and reports a spurious "double lock of a mutex"
// when the wait re-acquires — which is exactly what the stress harness's
// gating `go test -race` analogue would trip over on every run.  Under
// -fsanitize=thread we therefore route timed waits through a system_clock
// wait_until, whose pthread_cond_timedwait path IS intercepted.  The only
// behavioural difference — sensitivity to wall-clock steps during the wait —
// is confined to sanitizer builds.

#ifndef K8S_TPU_NATIVE_TSAN_WAIT_H_
#define K8S_TPU_NATIVE_TSAN_WAIT_H_

#include <chrono>
#include <condition_variable>
#include <mutex>

template <class Rep, class Period>
inline std::cv_status tsan_safe_wait_for(
    std::condition_variable& cv, std::unique_lock<std::mutex>& lock,
    const std::chrono::duration<Rep, Period>& dur) {
#if defined(__SANITIZE_THREAD__)
  return cv.wait_until(
      lock, std::chrono::system_clock::now() +
                std::chrono::duration_cast<std::chrono::system_clock::duration>(dur));
#else
  return cv.wait_for(lock, dur);
#endif
}

template <class Rep, class Period, class Pred>
inline bool tsan_safe_wait_for(std::condition_variable& cv,
                               std::unique_lock<std::mutex>& lock,
                               const std::chrono::duration<Rep, Period>& dur,
                               Pred pred) {
#if defined(__SANITIZE_THREAD__)
  return cv.wait_until(
      lock,
      std::chrono::system_clock::now() +
          std::chrono::duration_cast<std::chrono::system_clock::duration>(dur),
      pred);
#else
  return cv.wait_for(lock, dur, pred);
#endif
}

#endif  // K8S_TPU_NATIVE_TSAN_WAIT_H_
