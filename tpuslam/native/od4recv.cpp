// Native OD4 multicast endpoint — the live ingest data-loader.
//
// Native equivalent of libcluon's UDPReceiver/UDPSender pair (reference
// src/cluon-complete-build.hpp:5140-5340; impl :9129-9530): joins multicast
// group 225.0.0.<CID>:12175, runs a select()-driven receive thread with
// kernel RX timestamps (SIOCGSTAMP, reference :9486) and self-sent-datagram
// filtering (reference :9507-9513), and decouples the socket from the
// consumer through a condition-variable-guarded ring buffer — the same
// two-stage pipeline as the reference (:9398-9436), with Python draining
// the ring in batches instead of a per-envelope delegate thread.
//
// C API (handle-based, ctypes-friendly):
//   od4r_open(cid, port, rcvbuf)          -> handle (>0) or -errno
//   od4r_send(h, data, len)               -> bytes sent or -1
//   od4r_wait(h, timeout_us)              -> pending datagram count
//   od4r_drain(h, buf, cap, offs, lens, ts, maxn) -> datagrams copied
//   od4r_stats(h, &received, &dropped)
//   od4r_close(h)
//
// Build: make (g++ -O3 -shared -fPIC -pthread). Loaded via ctypes from
// tpuslam/native/receiver.py; tpuslam.io.od4 falls back to the pure asyncio
// endpoint when this library is unavailable.

#include <arpa/inet.h>
#include <netinet/in.h>
#include <sys/ioctl.h>
#include <sys/select.h>
#include <sys/socket.h>
#include <sys/time.h>
#include <unistd.h>
#ifdef __linux__
#include <linux/sockios.h>  // SIOCGSTAMP moved out of asm/sockios on glibc>=2.30
#endif
#ifndef SIOCGSTAMP
#define SIOCGSTAMP 0x8906
#endif

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>
#include <thread>
#include <vector>

namespace {

constexpr int64_t kArenaBytes = 1 << 22;   // 4 MiB datagram arena
constexpr int64_t kMaxQueued = 8192;       // datagram metadata slots
constexpr int64_t kMaxDatagram = 65507;

struct Datagram {
  int64_t off;
  int64_t len;
  int64_t ts_us;
};

struct Endpoint {
  int recv_fd = -1;
  int send_fd = -1;
  sockaddr_in group{};
  sockaddr_in self_addr{};  // send socket's (local ip, port) for self-filter
  std::thread rx_thread;
  std::atomic<bool> stop{false};
  std::atomic<int> active_calls{0};  // wait/drain calls in flight — close
                                     // spins these out before deleting

  std::mutex mu;
  std::condition_variable cv;
  std::vector<uint8_t> arena = std::vector<uint8_t>(kArenaBytes);
  std::vector<Datagram> queue;   // FIFO; drained in arrival order
  int64_t arena_used = 0;
  int64_t received = 0;
  int64_t dropped = 0;

  ~Endpoint() {
    stop.store(true);
    if (rx_thread.joinable()) rx_thread.join();
    if (recv_fd >= 0) ::close(recv_fd);
    if (send_fd >= 0) ::close(send_fd);
  }
};

std::mutex g_mu;
std::map<int64_t, Endpoint*> g_endpoints;
int64_t g_next_handle = 1;

// Acquire pins the endpoint against od4r_close: the refcount is taken under
// g_mu, and close() removes the map entry under g_mu before spinning the
// count to zero — so a pinned endpoint can never be deleted mid-call.
Endpoint* acquire(int64_t h) {
  std::lock_guard<std::mutex> l(g_mu);
  auto it = g_endpoints.find(h);
  if (it == g_endpoints.end()) return nullptr;
  it->second->active_calls.fetch_add(1);
  return it->second;
}

void release(Endpoint* ep) { ep->active_calls.fetch_sub(1); }

int64_t now_us_fallback() {
  return std::chrono::duration_cast<std::chrono::microseconds>(
             std::chrono::system_clock::now().time_since_epoch())
      .count();
}

void rx_loop(Endpoint* ep) {
  std::vector<uint8_t> buf(kMaxDatagram);
  while (!ep->stop.load(std::memory_order_relaxed)) {
    fd_set rfds;
    FD_ZERO(&rfds);
    FD_SET(ep->recv_fd, &rfds);
    timeval tv{0, 20000};  // 20 ms — the reference polls at 50 Hz (:9465)
    int r = ::select(ep->recv_fd + 1, &rfds, nullptr, nullptr, &tv);
    if (r <= 0) continue;

    sockaddr_in src{};
    socklen_t srclen = sizeof(src);
    ssize_t n = ::recvfrom(ep->recv_fd, buf.data(), buf.size(), 0,
                           reinterpret_cast<sockaddr*>(&src), &srclen);
    if (n <= 0) continue;

    // self-sent filtering: drop datagrams originating from our own send
    // socket (reference :9507-9513 compares sender port + local addresses)
    if (src.sin_port == ep->self_addr.sin_port &&
        src.sin_addr.s_addr == ep->self_addr.sin_addr.s_addr) {
      continue;
    }

    // kernel RX timestamp of the last datagram (reference :9486)
    int64_t ts = 0;
    timeval rx_tv{};
    if (::ioctl(ep->recv_fd, SIOCGSTAMP, &rx_tv) == 0) {
      ts = static_cast<int64_t>(rx_tv.tv_sec) * 1000000 + rx_tv.tv_usec;
    } else {
      ts = now_us_fallback();
    }

    std::lock_guard<std::mutex> l(ep->mu);
    if (static_cast<int64_t>(ep->queue.size()) >= kMaxQueued ||
        ep->arena_used + n > kArenaBytes) {
      ++ep->dropped;  // shed load like a full kernel socket buffer
      continue;
    }
    std::memcpy(ep->arena.data() + ep->arena_used, buf.data(), n);
    ep->queue.push_back({ep->arena_used, n, ts});
    ep->arena_used += n;
    ++ep->received;
    ep->cv.notify_all();
  }
}

}  // namespace

extern "C" {

int64_t od4r_open(uint32_t cid, uint16_t port, int rcvbuf,
                  const char* iface) {
  auto* ep = new Endpoint();

  char group_ip[32];
  std::snprintf(group_ip, sizeof(group_ip), "225.0.0.%u", cid & 0xFF);
  ep->group.sin_family = AF_INET;
  ep->group.sin_port = htons(port);
  ::inet_pton(AF_INET, group_ip, &ep->group.sin_addr);

  in_addr iface_addr{};
  iface_addr.s_addr = htonl(INADDR_ANY);
  if (iface != nullptr && iface[0] != '\0' &&
      std::strcmp(iface, "0.0.0.0") != 0) {
    ::inet_pton(AF_INET, iface, &iface_addr);
  }

  // receive socket: REUSE* so several sessions share the port on one host
  ep->recv_fd = ::socket(AF_INET, SOCK_DGRAM, 0);
  if (ep->recv_fd < 0) { delete ep; return -1; }
  int one = 1;
  ::setsockopt(ep->recv_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
#ifdef SO_REUSEPORT
  ::setsockopt(ep->recv_fd, SOL_SOCKET, SO_REUSEPORT, &one, sizeof(one));
#endif
  if (rcvbuf > 0) {
    ::setsockopt(ep->recv_fd, SOL_SOCKET, SO_RCVBUF, &rcvbuf, sizeof(rcvbuf));
  }
  sockaddr_in bind_addr{};
  bind_addr.sin_family = AF_INET;
  bind_addr.sin_port = htons(port);
  bind_addr.sin_addr.s_addr = iface_addr.s_addr;
  if (::bind(ep->recv_fd, reinterpret_cast<sockaddr*>(&bind_addr),
             sizeof(bind_addr)) < 0) {
    delete ep;
    return -2;
  }
  ip_mreq mreq{};
  mreq.imr_multiaddr = ep->group.sin_addr;
  mreq.imr_interface = iface_addr;
  if (::setsockopt(ep->recv_fd, IPPROTO_IP, IP_ADD_MEMBERSHIP, &mreq,
                   sizeof(mreq)) < 0) {
    delete ep;
    return -3;
  }

  // send socket: own ephemeral port, loop enabled so local peers hear us
  // (the reference's separate UDPSender, :5140-5222)
  ep->send_fd = ::socket(AF_INET, SOCK_DGRAM, 0);
  if (ep->send_fd < 0) { delete ep; return -4; }
  one = 1;
  ::setsockopt(ep->send_fd, IPPROTO_IP, IP_MULTICAST_LOOP, &one, sizeof(one));
  // learn our (ip, port) as peers will see it: connect() resolves the route
  if (::connect(ep->send_fd, reinterpret_cast<sockaddr*>(&ep->group),
                sizeof(ep->group)) == 0) {
    socklen_t len = sizeof(ep->self_addr);
    ::getsockname(ep->send_fd, reinterpret_cast<sockaddr*>(&ep->self_addr),
                  &len);
  }

  ep->queue.reserve(kMaxQueued);
  ep->rx_thread = std::thread(rx_loop, ep);

  std::lock_guard<std::mutex> l(g_mu);
  int64_t h = g_next_handle++;
  g_endpoints[h] = ep;
  return h;
}

int64_t od4r_send(int64_t h, const uint8_t* data, int64_t len) {
  Endpoint* ep = acquire(h);
  if (ep == nullptr) return -1;
  int64_t n = ep->send_fd < 0
                  ? -1
                  : ::send(ep->send_fd, data, static_cast<size_t>(len), 0);
  release(ep);
  return n;
}

// Block until >=1 datagram is queued or timeout; returns the queued count.
int64_t od4r_wait(int64_t h, int64_t timeout_us) {
  Endpoint* ep = acquire(h);
  if (ep == nullptr) return -1;
  int64_t n = -1;
  {
    std::unique_lock<std::mutex> l(ep->mu);
    if (ep->queue.empty() && !ep->stop.load()) {
      ep->cv.wait_for(l, std::chrono::microseconds(timeout_us), [&] {
        return !ep->queue.empty() || ep->stop.load();
      });
    }
    n = static_cast<int64_t>(ep->queue.size());
  }
  release(ep);
  return n;
}

// Copy all pending datagrams (up to maxn / cap bytes) into caller arrays.
// Returns the number of datagrams copied; the arena slots are recycled.
int64_t od4r_drain(int64_t h, uint8_t* buf, int64_t cap, int64_t* offs,
                   int64_t* lens, int64_t* ts_us, int64_t maxn) {
  Endpoint* ep = acquire(h);
  if (ep == nullptr) return -1;
  int64_t n = 0;
  {  // the guard must unlock BEFORE release(): after the refcount drops,
     // od4r_close may delete the mutex at any instant
    std::lock_guard<std::mutex> l(ep->mu);
    int64_t out = 0;
    size_t taken = 0;
    for (const Datagram& d : ep->queue) {
      if (n >= maxn || out + d.len > cap) break;
      std::memcpy(buf + out, ep->arena.data() + d.off, d.len);
      offs[n] = out;
      lens[n] = d.len;
      ts_us[n] = d.ts_us;
      out += d.len;
      ++n;
      ++taken;
    }
    if (taken == ep->queue.size()) {
      ep->queue.clear();
      ep->arena_used = 0;
    } else if (taken > 0) {
      // compact the remainder to the arena head (rare: partial drain)
      ep->queue.erase(ep->queue.begin(), ep->queue.begin() + taken);
      int64_t used = 0;
      for (Datagram& d : ep->queue) {
        std::memmove(ep->arena.data() + used, ep->arena.data() + d.off, d.len);
        d.off = used;
        used += d.len;
      }
      ep->arena_used = used;
    }
  }
  release(ep);
  return n;
}

void od4r_stats(int64_t h, int64_t* received, int64_t* dropped) {
  Endpoint* ep = acquire(h);
  if (ep == nullptr) return;
  {
    std::lock_guard<std::mutex> l(ep->mu);
    *received = ep->received;
    *dropped = ep->dropped;
  }
  release(ep);
}

void od4r_close(int64_t h) {
  Endpoint* ep = nullptr;
  {
    std::lock_guard<std::mutex> l(g_mu);
    auto it = g_endpoints.find(h);
    if (it == g_endpoints.end()) return;
    ep = it->second;
    g_endpoints.erase(it);
  }
  // Unblock + drain out any wait/drain calls still in flight (a Python
  // executor thread cannot be cancelled mid-call); only then destroy.
  ep->stop.store(true);
  ep->cv.notify_all();
  while (ep->active_calls.load() != 0) {
    std::this_thread::yield();
    ep->cv.notify_all();
  }
  delete ep;  // joins the rx thread
}

}  // extern "C"
