// Native streaming runtime: lock-free SPSC IQ ring buffer + streamers.
//
// Capability parity with the reference's native runtime pieces:
// lib/src/phy/utils/ringbuffer.c (byte ring buffer), lib/src/phy/io
// (file/UDP sample streams) and the radio class's continuous RX path
// (lib/src/radio/radio.cc rx_now) — the host-side sample pipeline that
// feeds device batches. C ABI for ctypes binding (no pybind11 in this
// environment).
//
// Design: single-producer/single-consumer ring with C11-style atomics,
// blocking reads with a deadline, a background file/UDP producer thread,
// and timestamp accounting in samples (the radio API's time_spec analog).

#include <atomic>
#include <chrono>
#include <complex>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>

#include <arpa/inet.h>
#include <netinet/in.h>
#include <sys/socket.h>
#include <unistd.h>

using cf_t = std::complex<float>;

namespace {

struct RingBuffer {
  cf_t *data = nullptr;
  size_t capacity = 0;  // samples, power of two
  size_t mask = 0;
  std::atomic<uint64_t> head{0};  // write position (samples, monotonic)
  std::atomic<uint64_t> tail{0};  // read position
  std::atomic<bool> stop{false};
  std::atomic<uint64_t> overflows{0};

  // producer thread state
  std::thread producer;
  int fd_socket = -1;
  FILE *file = nullptr;
  bool loop_file = false;
  double throttle_sps = 0.0;  // emulate a sample clock when > 0
};

size_t round_pow2(size_t n) {
  size_t p = 1;
  while (p < n) p <<= 1;
  return p;
}

}  // namespace

extern "C" {

RingBuffer *rb_create(size_t capacity_samples) {
  auto *rb = new RingBuffer();
  rb->capacity = round_pow2(capacity_samples);
  rb->mask = rb->capacity - 1;
  rb->data = new cf_t[rb->capacity];
  return rb;
}

void rb_destroy(RingBuffer *rb) {
  if (!rb) return;
  rb->stop.store(true);
  if (rb->producer.joinable()) rb->producer.join();
  if (rb->file) fclose(rb->file);
  if (rb->fd_socket >= 0) close(rb->fd_socket);
  delete[] rb->data;
  delete rb;
}

uint64_t rb_overflows(RingBuffer *rb) { return rb->overflows.load(); }
uint64_t rb_available(RingBuffer *rb) {
  return rb->head.load(std::memory_order_acquire) -
         rb->tail.load(std::memory_order_relaxed);
}

// Producer side: write n samples; drops (and counts) on overflow like a
// real radio overflow (rf_imp.c error handler analog).
size_t rb_write(RingBuffer *rb, const cf_t *src, size_t n) {
  uint64_t head = rb->head.load(std::memory_order_relaxed);
  uint64_t tail = rb->tail.load(std::memory_order_acquire);
  size_t free_space = rb->capacity - (size_t)(head - tail);
  size_t todo = n;
  if (todo > free_space) {
    rb->overflows.fetch_add(todo - free_space);
    todo = free_space;
  }
  size_t pos = (size_t)(head & rb->mask);
  size_t first = std::min(todo, rb->capacity - pos);
  memcpy(rb->data + pos, src, first * sizeof(cf_t));
  memcpy(rb->data, src + first, (todo - first) * sizeof(cf_t));
  rb->head.store(head + todo, std::memory_order_release);
  return todo;
}

// Consumer side: blocking read of exactly n samples (timeout_ms < 0 =
// wait forever; returns samples actually read). The rx_now analog:
// *timestamp receives the stream position of the first sample.
size_t rb_read(RingBuffer *rb, cf_t *dst, size_t n, int timeout_ms,
               uint64_t *timestamp) {
  using clock = std::chrono::steady_clock;
  auto deadline = clock::now() + std::chrono::milliseconds(
                                     timeout_ms < 0 ? 3600000 : timeout_ms);
  uint64_t tail = rb->tail.load(std::memory_order_relaxed);
  if (timestamp) *timestamp = tail;
  size_t done = 0;
  while (done < n) {
    uint64_t head = rb->head.load(std::memory_order_acquire);
    size_t avail = (size_t)(head - (tail + done));
    if (avail == 0) {
      if (rb->stop.load() || clock::now() > deadline) break;
      std::this_thread::sleep_for(std::chrono::microseconds(50));
      continue;
    }
    size_t todo = std::min(avail, n - done);
    size_t pos = (size_t)((tail + done) & rb->mask);
    size_t first = std::min(todo, rb->capacity - pos);
    memcpy(dst + done, rb->data + pos, first * sizeof(cf_t));
    memcpy(dst + done + first, rb->data, (todo - first) * sizeof(cf_t));
    done += todo;
  }
  rb->tail.store(tail + done, std::memory_order_release);
  return done;
}

// --- background producers ---------------------------------------------------

// Stream a complex-float binary IQ file into the ring (optionally looped,
// optionally throttled to a sample rate to emulate real-time RF).
int rb_start_file_producer(RingBuffer *rb, const char *path, int loop,
                           double throttle_sps) {
  rb->file = fopen(path, "rb");
  if (!rb->file) return -1;
  rb->loop_file = loop != 0;
  rb->throttle_sps = throttle_sps;
  rb->producer = std::thread([rb]() {
    const size_t chunk = 4096;
    cf_t buf[chunk];
    auto t0 = std::chrono::steady_clock::now();
    uint64_t sent = 0;
    while (!rb->stop.load()) {
      size_t n = fread(buf, sizeof(cf_t), chunk, rb->file);
      if (n == 0) {
        if (rb->loop_file) {
          fseek(rb->file, 0, SEEK_SET);
          continue;
        }
        break;
      }
      size_t off = 0;
      while (off < n && !rb->stop.load()) {
        off += rb_write(rb, buf + off, n - off);
        if (off < n)
          std::this_thread::sleep_for(std::chrono::microseconds(100));
      }
      sent += n;
      if (rb->throttle_sps > 0) {
        auto target = t0 + std::chrono::microseconds(
                               (int64_t)(1e6 * sent / rb->throttle_sps));
        std::this_thread::sleep_until(target);
      }
    }
  });
  return 0;
}

// Stream UDP datagrams of complex-float samples into the ring
// (netsource.c analog with the ring decoupling RX from compute).
int rb_start_udp_producer(RingBuffer *rb, const char *bind_addr, int port) {
  int fd = socket(AF_INET, SOCK_DGRAM, 0);
  if (fd < 0) return -1;
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons((uint16_t)port);
  addr.sin_addr.s_addr =
      bind_addr && *bind_addr ? inet_addr(bind_addr) : INADDR_ANY;
  if (bind(fd, (sockaddr *)&addr, sizeof(addr)) < 0) {
    close(fd);
    return -2;
  }
  timeval tv{0, 100000};  // 100 ms poll so stop() is honored
  setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
  rb->fd_socket = fd;
  rb->producer = std::thread([rb]() {
    cf_t buf[8192];
    while (!rb->stop.load()) {
      ssize_t got = recv(rb->fd_socket, buf, sizeof(buf), 0);
      if (got <= 0) continue;
      size_t n = (size_t)got / sizeof(cf_t);
      size_t off = 0;
      while (off < n && !rb->stop.load()) {
        off += rb_write(rb, buf + off, n - off);
        if (off < n)
          std::this_thread::sleep_for(std::chrono::microseconds(100));
      }
    }
  });
  return 0;
}

int rb_bound_port(RingBuffer *rb) {
  if (rb->fd_socket < 0) return -1;
  sockaddr_in addr{};
  socklen_t len = sizeof(addr);
  if (getsockname(rb->fd_socket, (sockaddr *)&addr, &len) < 0) return -1;
  return ntohs(addr.sin_port);
}

void rb_stop(RingBuffer *rb) { rb->stop.store(true); }

}  // extern "C"
