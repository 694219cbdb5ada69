// C++ client for the ratelimiter_tpu serving protocol: the port's copy of
// clients/cpp/ratelimiter_client.hpp, the native-code counterpart of the
// Python client (ratelimiter_tpu_torch/serving/client.py), speaking the
// same length-prefixed little-endian protocol (serving/protocol.py
// documents the frames).
//
// Header-only, POSIX sockets, no dependencies:
//
//   #include "ratelimiter_client.hpp"
//   rltpu::Client c("127.0.0.1", 8432);
//   auto r = c.allow("user:1");
//   if (!r.allowed) backoff(r.retry_after);
//
// Thread safety: one Client per thread (or external locking) — same
// contract as the Python blocking client. Errors surface as
// rltpu::RateLimitError with the server's error code preserved, so
// callers can distinguish invalid_n from storage_unavailable.
//
// Build: header-only; native/loadgen.cpp includes it.

#pragma once

#include <arpa/inet.h>
#include <netdb.h>
#include <string.h>
#include <sys/socket.h>
#include <sys/un.h>
#include <unistd.h>

#include <cstdint>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace rltpu {

// Protocol constants (serving/protocol.py).
enum : uint8_t {
  T_ALLOW_N = 1,
  T_RESET = 2,
  T_HEALTH = 3,
  T_METRICS = 4,
  T_ALLOW_BATCH = 5,
  T_ALLOW_HASHED = 11,
  T_RESULT = 129,
  T_OK = 130,
  T_HEALTH_R = 131,
  T_METRICS_R = 132,
  T_RESULT_BATCH = 133,
  T_RESULT_HASHED = 136,
  T_ERROR = 255,
};

struct Result {
  bool allowed = false;
  bool fail_open = false;
  int64_t limit = 0;
  int64_t remaining = 0;
  double retry_after = 0.0;
  double reset_at = 0.0;
};

struct Health {
  bool serving = false;
  double uptime_s = 0.0;
  uint64_t decisions_total = 0;
};

class RateLimitError : public std::runtime_error {
 public:
  RateLimitError(uint16_t code, const std::string& msg)
      : std::runtime_error(msg), code(code) {}
  uint16_t code;  // protocol.py E_* values
};

class ProtocolError : public std::runtime_error {
  using std::runtime_error::runtime_error;
};

class Client {
 public:
  // `host` may be a unix socket path — "unix:/run/rl.sock" or any
  // leading-slash path (port ignored) — for the same-host UDS listener
  // (ADR-025); otherwise it resolves as an IPv4 host.
  Client(const std::string& host, uint16_t port) : req_id_(0) {
    if (host.rfind("unix:", 0) == 0 || (!host.empty() && host[0] == '/')) {
      std::string path = host.rfind("unix:", 0) == 0 ? host.substr(5) : host;
      fd_ = ::socket(AF_UNIX, SOCK_STREAM, 0);
      struct sockaddr_un a {};
      a.sun_family = AF_UNIX;
      if (fd_ < 0 || path.size() >= sizeof(a.sun_path))
        throw ProtocolError("bad unix socket path " + path);
      std::memcpy(a.sun_path, path.c_str(), path.size());
      if (::connect(fd_, reinterpret_cast<sockaddr*>(&a), sizeof(a)) != 0) {
        ::close(fd_);
        throw ProtocolError("connect failed to " + path);
      }
      return;
    }
    struct addrinfo hints{}, *res = nullptr;
    hints.ai_family = AF_INET;
    hints.ai_socktype = SOCK_STREAM;
    std::string port_s = std::to_string(port);
    if (getaddrinfo(host.c_str(), port_s.c_str(), &hints, &res) != 0)
      throw ProtocolError("getaddrinfo failed for " + host);
    fd_ = ::socket(res->ai_family, res->ai_socktype, res->ai_protocol);
    if (fd_ < 0 || ::connect(fd_, res->ai_addr, res->ai_addrlen) != 0) {
      freeaddrinfo(res);
      if (fd_ >= 0) ::close(fd_);
      throw ProtocolError("connect failed to " + host + ":" + port_s);
    }
    freeaddrinfo(res);
    int one = 1;
    setsockopt(fd_, IPPROTO_TCP, /*TCP_NODELAY=*/1, &one, sizeof(one));
  }

  ~Client() {
    if (fd_ >= 0) ::close(fd_);
  }
  Client(const Client&) = delete;
  Client& operator=(const Client&) = delete;

  Result allow(const std::string& key) { return allow_n(key, 1); }

  Result allow_n(const std::string& key, uint32_t n) {
    std::vector<uint8_t> body;
    put_u32(body, n);
    put_key(body, key);
    auto [type, resp] = roundtrip(T_ALLOW_N, body);
    if (type != T_RESULT) throw ProtocolError("unexpected response type");
    return parse_result(resp.data(), resp.size());
  }

  // One ALLOW_BATCH frame; results in request order.
  std::vector<Result> allow_batch(const std::vector<std::string>& keys,
                                  const std::vector<uint32_t>* ns = nullptr) {
    std::vector<uint8_t> body;
    put_u32(body, static_cast<uint32_t>(keys.size()));
    for (size_t i = 0; i < keys.size(); ++i) {
      put_u32(body, ns ? (*ns)[i] : 1u);
      put_key(body, keys[i]);
    }
    auto [type, resp] = roundtrip(T_ALLOW_BATCH, body);
    if (type != T_RESULT_BATCH) throw ProtocolError("unexpected response type");
    const uint8_t* p = resp.data();
    size_t len = resp.size();
    if (len < 12) throw ProtocolError("short RESULT_BATCH");
    int64_t limit = get_i64(p);
    uint32_t count = get_u32(p + 8);
    p += 12;
    len -= 12;
    std::vector<Result> out;
    out.reserve(count);
    for (uint32_t i = 0; i < count; ++i) {
      if (len < 25) throw ProtocolError("truncated RESULT_BATCH item");
      Result r;
      r.allowed = p[0] & 1;
      r.fail_open = p[0] & 2;
      r.limit = limit;
      r.remaining = get_i64(p + 1);
      r.retry_after = get_f64(p + 9);
      r.reset_at = get_f64(p + 17);
      out.push_back(r);
      p += 25;
      len -= 25;
    }
    return out;
  }

  void reset(const std::string& key) {
    std::vector<uint8_t> body;
    put_key(body, key);
    auto [type, resp] = roundtrip(T_RESET, body);
    (void)resp;
    if (type != T_OK) throw ProtocolError("unexpected response type");
  }

  Health health() {
    auto [type, resp] = roundtrip(T_HEALTH, {});
    if (type != T_HEALTH_R || resp.size() < 17)
      throw ProtocolError("bad HEALTH response");
    Health h;
    h.serving = resp[0] == 1;
    h.uptime_s = get_f64(resp.data() + 1);
    std::memcpy(&h.decisions_total, resp.data() + 9, 8);
    return h;
  }

  std::string metrics() {
    auto [type, resp] = roundtrip(T_METRICS, {});
    if (type != T_METRICS_R || resp.size() < 4)
      throw ProtocolError("bad METRICS response");
    uint32_t n = get_u32(resp.data());
    return std::string(reinterpret_cast<const char*>(resp.data()) + 4, n);
  }

 private:
  int fd_;
  uint64_t req_id_;

  // ---- little-endian packing helpers (x86/ARM-LE hosts) ----
  static void put_u32(std::vector<uint8_t>& b, uint32_t v) {
    b.insert(b.end(), reinterpret_cast<uint8_t*>(&v),
             reinterpret_cast<uint8_t*>(&v) + 4);
  }
  static void put_u16(std::vector<uint8_t>& b, uint16_t v) {
    b.insert(b.end(), reinterpret_cast<uint8_t*>(&v),
             reinterpret_cast<uint8_t*>(&v) + 2);
  }
  static void put_key(std::vector<uint8_t>& b, const std::string& k) {
    put_u16(b, static_cast<uint16_t>(k.size()));
    b.insert(b.end(), k.begin(), k.end());
  }
  static uint32_t get_u32(const uint8_t* p) {
    uint32_t v;
    std::memcpy(&v, p, 4);
    return v;
  }
  static int64_t get_i64(const uint8_t* p) {
    int64_t v;
    std::memcpy(&v, p, 8);
    return v;
  }
  static double get_f64(const uint8_t* p) {
    double v;
    std::memcpy(&v, p, 8);
    return v;
  }

  void send_all(const uint8_t* p, size_t n) {
    while (n) {
      ssize_t w = ::send(fd_, p, n, 0);
      if (w <= 0) throw ProtocolError("send failed");
      p += w;
      n -= static_cast<size_t>(w);
    }
  }
  void recv_all(uint8_t* p, size_t n) {
    while (n) {
      ssize_t r = ::recv(fd_, p, n, 0);
      if (r <= 0) throw ProtocolError("connection closed by server");
      p += r;
      n -= static_cast<size_t>(r);
    }
  }

  std::pair<uint8_t, std::vector<uint8_t>> roundtrip(
      uint8_t type, const std::vector<uint8_t>& body) {
    uint64_t id = ++req_id_;
    std::vector<uint8_t> frame;
    put_u32(frame, static_cast<uint32_t>(1 + 8 + body.size()));
    frame.push_back(type);
    frame.insert(frame.end(), reinterpret_cast<uint8_t*>(&id),
                 reinterpret_cast<uint8_t*>(&id) + 8);
    frame.insert(frame.end(), body.begin(), body.end());
    send_all(frame.data(), frame.size());

    uint8_t hdr[13];
    recv_all(hdr, 13);
    uint32_t length = get_u32(hdr);
    uint8_t rtype = hdr[4];
    uint64_t rid;
    std::memcpy(&rid, hdr + 5, 8);
    if (length < 9 || length > (1u << 20))
      throw ProtocolError("bad frame length");
    std::vector<uint8_t> resp(length - 9);
    recv_all(resp.data(), resp.size());
    if (rid != id) throw ProtocolError("response id mismatch");
    if (rtype == T_ERROR) {
      if (resp.size() < 4) throw ProtocolError("short ERROR frame");
      uint16_t code, mlen;
      std::memcpy(&code, resp.data(), 2);
      std::memcpy(&mlen, resp.data() + 2, 2);
      throw RateLimitError(
          code, std::string(reinterpret_cast<char*>(resp.data()) + 4, mlen));
    }
    return {rtype, std::move(resp)};
  }

  static Result parse_result(const uint8_t* p, size_t len) {
    if (len < 33) throw ProtocolError("short RESULT frame");
    Result r;
    r.allowed = p[0] & 1;
    r.fail_open = p[0] & 2;
    r.limit = get_i64(p + 1);
    r.remaining = get_i64(p + 9);
    r.retry_after = get_f64(p + 17);
    r.reset_at = get_f64(p + 25);
    return r;
  }
};

}  // namespace rltpu
