// Coordination key-value store of the port (counterpart of
// paddle_tpu/native/coord_store.cc, the same wire protocol and C ABI):
// a rank-0-hosted TCP KV daemon with set/get/add/wait/delete/keys, and a
// client with a native heartbeat thread. The serving tier's process
// replicas speak over it (inference/replica.py: requests, replies, token
// frames and control commands are keys) and the router's watchdog reads
// its heartbeat receipt stamps.
//
// Design: one poll()-driven single-threaded daemon (no thread per
// connection, no lock on the hot path); clients speak a length-prefixed
// binary protocol; WAIT parks the client on an in-daemon waitlist woken by
// SET/ADD. Heartbeats are ordinary keys with server-side receipt
// timestamps, so the watchdog is a pure reader.
//
// Three changes from the reference's copy, for process replicas that are
// SIGSTOPped: a client sends each command in one write; the daemon drops a
// client that blocks it for kIoTimeoutMs (the reference's daemon blocks
// forever on a client frozen in the middle of a command, and with it every
// client, heartbeats included); and a client whose exchange fails (it was
// dropped while stopped mid-transfer) reconnects and sends the command
// again when running it twice is harmless (every command but ADD), so a
// process that is continued goes on as it does against the reference's
// daemon.
//
// C ABI only, loaded with ctypes (distributed/store.py); built with the
// host C++ compiler by paddle_tpu_torch/native/__init__.py.

#include <arpa/inet.h>
#include <errno.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <stdint.h>
#include <string.h>
#include <sys/socket.h>
#include <sys/time.h>
#include <unistd.h>

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdio>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

enum Cmd : uint8_t {
  CMD_SET = 1,
  CMD_GET = 2,
  CMD_ADD = 3,
  CMD_WAIT = 4,    // block until key exists
  CMD_DELETE = 5,
  CMD_KEYS = 6,    // list keys with a prefix
  CMD_STAMP = 7,   // server-receipt age query: ms since key last written
  CMD_PING = 8,
};

enum Status : uint8_t {
  ST_OK = 0,
  ST_NOT_FOUND = 1,
  ST_ERROR = 2,
};

constexpr int kIoTimeoutMs = 200;  // the daemon's longest wait on one client
constexpr int kReconnectMs = 250;  // a client's reconnect after a drop

int64_t now_ms() {
  return std::chrono::duration_cast<std::chrono::milliseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

// ---- wire helpers (blocking fd) -------------------------------------------

bool send_all(int fd, const void* buf, size_t n) {
  const char* p = static_cast<const char*>(buf);
  while (n > 0) {
    ssize_t k = ::send(fd, p, n, MSG_NOSIGNAL);
    if (k <= 0) {
      if (k < 0 && (errno == EINTR)) continue;
      return false;
    }
    p += k;
    n -= static_cast<size_t>(k);
  }
  return true;
}

bool recv_all(int fd, void* buf, size_t n) {
  char* p = static_cast<char*>(buf);
  while (n > 0) {
    ssize_t k = ::recv(fd, p, n, 0);
    if (k <= 0) {
      if (k < 0 && errno == EINTR) continue;
      return false;
    }
    p += k;
    n -= static_cast<size_t>(k);
  }
  return true;
}

bool send_u32(int fd, uint32_t v) {
  uint32_t be = htonl(v);
  return send_all(fd, &be, 4);
}

bool recv_u32(int fd, uint32_t* v) {
  uint32_t be;
  if (!recv_all(fd, &be, 4)) return false;
  *v = ntohl(be);
  return true;
}

bool send_bytes(int fd, const std::string& s) {
  return send_u32(fd, static_cast<uint32_t>(s.size())) &&
         (s.empty() || send_all(fd, s.data(), s.size()));
}

// A client's command goes out in ONE send: a process stopped between two
// sends of one command (the serving tier's wedge is a SIGSTOP) would leave
// the daemon holding half of it.
void put_u32(std::string* m, uint32_t v) {
  uint32_t be = htonl(v);
  m->append(reinterpret_cast<const char*>(&be), 4);
}

void put_bytes(std::string* m, const std::string& s) {
  put_u32(m, static_cast<uint32_t>(s.size()));
  m->append(s);
}

void put_i64(std::string* m, int64_t v) {
  m->append(reinterpret_cast<const char*>(&v), 8);
}

std::string command(uint8_t cmd, const std::string& key) {
  std::string m(1, static_cast<char>(cmd));
  put_bytes(&m, key);
  return m;
}

bool recv_bytes(int fd, std::string* s) {
  uint32_t n;
  if (!recv_u32(fd, &n)) return false;
  if (n > (64u << 20)) return false;  // sanity cap: 64 MiB per value
  s->resize(n);
  return n == 0 || recv_all(fd, &(*s)[0], n);
}

// ---- server ---------------------------------------------------------------

struct Entry {
  std::string value;
  int64_t stamp_ms = 0;  // server receipt time of last write
};

class Daemon {
 public:
  explicit Daemon(int port) : port_(port) {}

  // Returns bound port (for port=0 auto-assign), or -1 on failure.
  int Start() {
    listen_fd_ = ::socket(AF_INET, SOCK_STREAM, 0);
    if (listen_fd_ < 0) return -1;
    int one = 1;
    setsockopt(listen_fd_, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_addr.s_addr = htonl(INADDR_ANY);
    addr.sin_port = htons(static_cast<uint16_t>(port_));
    if (bind(listen_fd_, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) <
            0 ||
        listen(listen_fd_, 128) < 0) {
      ::close(listen_fd_);
      return -1;
    }
    socklen_t len = sizeof(addr);
    getsockname(listen_fd_, reinterpret_cast<sockaddr*>(&addr), &len);
    port_ = ntohs(addr.sin_port);
    running_.store(true);
    thread_ = std::thread([this] { Loop(); });
    return port_;
  }

  void Stop() {
    running_.store(false);
    // nudge the poll loop awake via a self-connection
    int fd = ::socket(AF_INET, SOCK_STREAM, 0);
    if (fd >= 0) {
      sockaddr_in addr{};
      addr.sin_family = AF_INET;
      addr.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
      addr.sin_port = htons(static_cast<uint16_t>(port_));
      connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr));
      ::close(fd);
    }
    if (thread_.joinable()) thread_.join();
    ::close(listen_fd_);
    for (auto& c : clients_) ::close(c.fd);
    clients_.clear();
  }

  int port() const { return port_; }

 private:
  struct Client {
    int fd;
    // a WAITing client is parked here until its key appears
    bool waiting = false;
    std::string wait_key;
    int64_t wait_deadline_ms = 0;  // 0 = forever
  };

  void Loop() {
    while (running_.load()) {
      std::vector<pollfd> pfds;
      pfds.push_back({listen_fd_, POLLIN, 0});
      for (auto& c : clients_)
        pfds.push_back({c.fd, static_cast<short>(c.waiting ? 0 : POLLIN), 0});
      // bounded poll so parked WAIT timeouts fire
      ::poll(pfds.data(), pfds.size(), 50);
      if (!running_.load()) break;
      if (pfds[0].revents & POLLIN) Accept();
      // iterate over a snapshot: Serve() may append (never removes)
      size_t n = clients_.size();
      std::vector<size_t> dead;
      for (size_t i = 0; i < n && i + 1 < pfds.size(); i++) {
        auto& c = clients_[i];
        if (c.waiting) {
          if (TryWake(&c)) continue;
          if (c.wait_deadline_ms && now_ms() > c.wait_deadline_ms) {
            uint8_t st = ST_NOT_FOUND;
            send_all(c.fd, &st, 1);
            c.waiting = false;
          }
          continue;
        }
        if (pfds[i + 1].revents & (POLLIN | POLLHUP | POLLERR)) {
          if (!Serve(&c)) dead.push_back(i);
        }
      }
      for (auto it = dead.rbegin(); it != dead.rend(); ++it) {
        ::close(clients_[*it].fd);
        clients_.erase(clients_.begin() + static_cast<long>(*it));
      }
    }
  }

  void Accept() {
    int fd = ::accept(listen_fd_, nullptr, nullptr);
    if (fd < 0) return;
    int one = 1;
    setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    // the daemon is one thread: a client frozen in the middle of a
    // command (stopped, or its half sent past a full buffer) or one that
    // stops reading its replies must not freeze every other client; past
    // kIoTimeoutMs its blocked read or write fails and the client is
    // dropped
    timeval tv{};
    tv.tv_sec = kIoTimeoutMs / 1000;
    tv.tv_usec = (kIoTimeoutMs % 1000) * 1000;
    setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
    setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof(tv));
    clients_.push_back(Client{fd});
  }

  bool TryWake(Client* c) {
    auto it = data_.find(c->wait_key);
    if (it == data_.end()) return false;
    uint8_t st = ST_OK;
    if (!send_all(c->fd, &st, 1) || !send_bytes(c->fd, it->second.value)) {
      // connection died mid-wake: resume POLLIN so the next loop reaps it
      c->waiting = false;
      return false;
    }
    c->waiting = false;
    return true;
  }

  bool Serve(Client* c) {
    uint8_t cmd;
    if (!recv_all(c->fd, &cmd, 1)) return false;
    switch (cmd) {
      case CMD_SET: {
        std::string key, val;
        if (!recv_bytes(c->fd, &key) || !recv_bytes(c->fd, &val)) return false;
        data_[key] = Entry{std::move(val), now_ms()};
        uint8_t st = ST_OK;
        return send_all(c->fd, &st, 1);
      }
      case CMD_GET: {
        std::string key;
        if (!recv_bytes(c->fd, &key)) return false;
        auto it = data_.find(key);
        uint8_t st = it == data_.end() ? ST_NOT_FOUND : ST_OK;
        if (!send_all(c->fd, &st, 1)) return false;
        if (st == ST_OK) return send_bytes(c->fd, it->second.value);
        return true;
      }
      case CMD_ADD: {
        std::string key;
        int64_t delta;
        if (!recv_bytes(c->fd, &key) || !recv_all(c->fd, &delta, 8))
          return false;
        int64_t cur = 0;
        auto it = data_.find(key);
        if (it != data_.end() && !it->second.value.empty())
          cur = strtoll(it->second.value.c_str(), nullptr, 10);
        cur += delta;
        data_[key] = Entry{std::to_string(cur), now_ms()};
        uint8_t st = ST_OK;
        return send_all(c->fd, &st, 1) && send_all(c->fd, &cur, 8);
      }
      case CMD_WAIT: {
        std::string key;
        int64_t timeout_ms;
        if (!recv_bytes(c->fd, &key) || !recv_all(c->fd, &timeout_ms, 8))
          return false;
        c->wait_key = key;
        c->wait_deadline_ms = timeout_ms > 0 ? now_ms() + timeout_ms : 0;
        c->waiting = true;
        TryWake(c);  // may satisfy immediately
        return true;
      }
      case CMD_DELETE: {
        std::string key;
        if (!recv_bytes(c->fd, &key)) return false;
        uint8_t st = data_.erase(key) ? ST_OK : ST_NOT_FOUND;
        return send_all(c->fd, &st, 1);
      }
      case CMD_KEYS: {
        std::string prefix;
        if (!recv_bytes(c->fd, &prefix)) return false;
        std::string joined;
        for (auto& kv : data_) {
          if (kv.first.compare(0, prefix.size(), prefix) == 0) {
            joined += kv.first;
            joined += '\n';
          }
        }
        uint8_t st = ST_OK;
        return send_all(c->fd, &st, 1) && send_bytes(c->fd, joined);
      }
      case CMD_STAMP: {
        std::string key;
        if (!recv_bytes(c->fd, &key)) return false;
        auto it = data_.find(key);
        uint8_t st = it == data_.end() ? ST_NOT_FOUND : ST_OK;
        int64_t age = it == data_.end() ? -1 : now_ms() - it->second.stamp_ms;
        return send_all(c->fd, &st, 1) && send_all(c->fd, &age, 8);
      }
      case CMD_PING: {
        uint8_t st = ST_OK;
        return send_all(c->fd, &st, 1);
      }
      default:
        return false;
    }
  }

  int port_;
  int listen_fd_ = -1;
  std::atomic<bool> running_{false};
  std::thread thread_;
  std::vector<Client> clients_;               // daemon-thread-only
  std::map<std::string, Entry> data_;         // daemon-thread-only (ordered
                                              // for prefix listing)
};

// ---- client ---------------------------------------------------------------

class StoreClient {
 public:
  // each call opens its own request/response exchange on one persistent
  // connection; a mutex serializes callers (heartbeat thread + user thread)
  bool Connect(const std::string& host, int port, int64_t timeout_ms) {
    host_ = host;
    port_ = port;
    // resolve hostnames too (masters are usually named hosts, not IPs)
    addrinfo hints{}, *res = nullptr;
    hints.ai_family = AF_INET;
    hints.ai_socktype = SOCK_STREAM;
    if (getaddrinfo(host.c_str(), std::to_string(port).c_str(), &hints,
                    &res) != 0 ||
        res == nullptr)
      return false;
    int64_t deadline = now_ms() + timeout_ms;
    bool ok = false;
    do {
      fd_ = ::socket(AF_INET, SOCK_STREAM, 0);
      if (fd_ < 0) break;
      if (connect(fd_, res->ai_addr, res->ai_addrlen) == 0) {
        int one = 1;
        setsockopt(fd_, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
        ok = true;
        break;
      }
      ::close(fd_);
      fd_ = -1;
      std::this_thread::sleep_for(std::chrono::milliseconds(50));
    } while (now_ms() < deadline);
    freeaddrinfo(res);
    return ok;
  }

  void Close() {
    std::lock_guard<std::mutex> g(mu_);
    if (fd_ >= 0) ::close(fd_);
    fd_ = -1;
  }

  // One request/response on the connection (mu_ held): send `m`, then
  // `reply()` reads the answer and returns -1 on a broken connection, else
  // its result. A broken exchange reconnects; with `resend` the command
  // goes out once more on the new connection.
  template <typename F>
  int Exchange(const std::string& m, bool resend, F&& reply) {
    for (int attempt = 0;; attempt++) {
      if (fd_ >= 0 && send_all(fd_, m.data(), m.size())) {
        int rc = reply();
        if (rc != -1) return rc;
      }
      if (fd_ >= 0) ::close(fd_);
      fd_ = -1;
      if (!Connect(host_, port_, kReconnectMs) || !resend || attempt == 1)
        return -1;
    }
  }

  int Set(const std::string& key, const std::string& val) {
    std::lock_guard<std::mutex> g(mu_);
    std::string m = command(CMD_SET, key);
    put_bytes(&m, val);
    return Exchange(m, true, [&] {
      uint8_t st;
      if (!recv_all(fd_, &st, 1)) return -1;
      return st == ST_OK ? 0 : 2;
    }) == 0 ? 0 : -1;
  }

  int Get(const std::string& key, std::string* val) {
    std::lock_guard<std::mutex> g(mu_);
    return Exchange(command(CMD_GET, key), true, [&] {
      uint8_t st;
      if (!recv_all(fd_, &st, 1)) return -1;
      if (st != ST_OK) return 1;  // not found
      return recv_bytes(fd_, val) ? 0 : -1;
    });
  }

  int Add(const std::string& key, int64_t delta, int64_t* out) {
    std::lock_guard<std::mutex> g(mu_);
    std::string m = command(CMD_ADD, key);
    put_i64(&m, delta);
    // not resent: an ADD that reached the daemon before the connection
    // broke has counted once already
    return Exchange(m, false, [&] {
      uint8_t st;
      if (!recv_all(fd_, &st, 1) || !recv_all(fd_, out, 8)) return -1;
      return st == ST_OK ? 0 : 2;
    }) == 0 ? 0 : -1;
  }

  int Wait(const std::string& key, int64_t timeout_ms, std::string* val) {
    std::lock_guard<std::mutex> g(mu_);
    std::string m = command(CMD_WAIT, key);
    put_i64(&m, timeout_ms);
    return Exchange(m, true, [&] {
      uint8_t st;
      if (!recv_all(fd_, &st, 1)) return -1;
      if (st != ST_OK) return 1;  // timed out
      return recv_bytes(fd_, val) ? 0 : -1;
    });
  }

  int Delete(const std::string& key) {
    std::lock_guard<std::mutex> g(mu_);
    return Exchange(command(CMD_DELETE, key), true, [&] {
      uint8_t st;
      if (!recv_all(fd_, &st, 1)) return -1;
      return st == ST_OK ? 0 : 1;
    });
  }

  int Keys(const std::string& prefix, std::string* joined) {
    std::lock_guard<std::mutex> g(mu_);
    return Exchange(command(CMD_KEYS, prefix), true, [&] {
      uint8_t st;
      return recv_all(fd_, &st, 1) && recv_bytes(fd_, joined) ? 0 : -1;
    });
  }

  int StampAge(const std::string& key, int64_t* age_ms) {
    std::lock_guard<std::mutex> g(mu_);
    return Exchange(command(CMD_STAMP, key), true, [&] {
      uint8_t st;
      if (!recv_all(fd_, &st, 1) || !recv_all(fd_, age_ms, 8)) return -1;
      return st == ST_OK ? 0 : 1;
    });
  }

  // ---- heartbeat publisher (the watchdog's write side) ----
  // Runs on its OWN connection: the main connection's mutex is held for
  // the full duration of a parked Wait/barrier, and a rank sitting at a
  // barrier must keep heartbeating or the watchdog declares it dead.
  void StartHeartbeat(const std::string& key, int64_t interval_ms) {
    StopHeartbeat();
    hb_run_.store(true);
    std::string host = host_;
    int port = port_;
    hb_thread_ = std::thread([this, key, interval_ms, host, port] {
      StoreClient hb;
      bool connected = false;
      while (hb_run_.load()) {
        if (!connected) connected = hb.Connect(host, port, 2000);
        if (connected && hb.Set(key, std::to_string(now_ms())) != 0) {
          // connection broke: reconnect on the next beat
          hb.Close();
          connected = false;
        }
        std::unique_lock<std::mutex> lk(hb_mu_);
        hb_cv_.wait_for(lk, std::chrono::milliseconds(interval_ms),
                        [this] { return !hb_run_.load(); });
      }
      hb.Close();
    });
  }

  void StopHeartbeat() {
    hb_run_.store(false);
    hb_cv_.notify_all();
    if (hb_thread_.joinable()) hb_thread_.join();
  }

 private:
  int fd_ = -1;
  std::string host_;
  int port_ = 0;
  std::mutex mu_;
  std::thread hb_thread_;
  std::atomic<bool> hb_run_{false};
  std::mutex hb_mu_;
  std::condition_variable hb_cv_;
};

}  // namespace

// ---- C ABI ----------------------------------------------------------------

extern "C" {

void* pts_server_start(int port, int* bound_port) {
  auto* d = new Daemon(port);
  int p = d->Start();
  if (p < 0) {
    delete d;
    return nullptr;
  }
  if (bound_port) *bound_port = p;
  return d;
}

void pts_server_stop(void* h) {
  auto* d = static_cast<Daemon*>(h);
  d->Stop();
  delete d;
}

void* pts_connect(const char* host, int port, int64_t timeout_ms) {
  auto* c = new StoreClient();
  if (!c->Connect(host, port, timeout_ms)) {
    delete c;
    return nullptr;
  }
  return c;
}

void pts_close(void* h) {
  auto* c = static_cast<StoreClient*>(h);
  c->StopHeartbeat();
  c->Close();
  delete c;
}

int pts_set(void* h, const char* key, const char* val, int val_len) {
  return static_cast<StoreClient*>(h)->Set(key, std::string(val, val_len));
}

// Returns length (>=0) or -1 error / -2 not found. Caller frees via
// pts_free_buf.
int pts_get(void* h, const char* key, char** out) {
  std::string v;
  int rc = static_cast<StoreClient*>(h)->Get(key, &v);
  if (rc != 0) return rc < 0 ? -1 : -2;
  *out = static_cast<char*>(malloc(v.size() + 1));
  memcpy(*out, v.data(), v.size());
  (*out)[v.size()] = 0;
  return static_cast<int>(v.size());
}

int pts_wait(void* h, const char* key, int64_t timeout_ms, char** out) {
  std::string v;
  int rc = static_cast<StoreClient*>(h)->Wait(key, timeout_ms, &v);
  if (rc != 0) return rc < 0 ? -1 : -2;
  *out = static_cast<char*>(malloc(v.size() + 1));
  memcpy(*out, v.data(), v.size());
  (*out)[v.size()] = 0;
  return static_cast<int>(v.size());
}

void pts_free_buf(char* p) { free(p); }

int64_t pts_add(void* h, const char* key, int64_t delta) {
  int64_t out = 0;
  if (static_cast<StoreClient*>(h)->Add(key, delta, &out) != 0) return -1;
  return out;
}

int pts_delete(void* h, const char* key) {
  return static_cast<StoreClient*>(h)->Delete(key);
}

int pts_keys(void* h, const char* prefix, char** out) {
  std::string v;
  if (static_cast<StoreClient*>(h)->Keys(prefix, &v) != 0) return -1;
  *out = static_cast<char*>(malloc(v.size() + 1));
  memcpy(*out, v.data(), v.size());
  (*out)[v.size()] = 0;
  return static_cast<int>(v.size());
}

// ms since last write of key; -1 not found / error.
int64_t pts_stamp_age_ms(void* h, const char* key) {
  int64_t age = -1;
  if (static_cast<StoreClient*>(h)->StampAge(key, &age) != 0) return -1;
  return age;
}

void pts_heartbeat_start(void* h, const char* key, int64_t interval_ms) {
  static_cast<StoreClient*>(h)->StartHeartbeat(key, interval_ms);
}

void pts_heartbeat_stop(void* h) {
  static_cast<StoreClient*>(h)->StopHeartbeat();
}

}  // extern "C"
