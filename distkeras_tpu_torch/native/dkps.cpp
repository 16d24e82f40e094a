// dkps — native parameter-server transport core.
//
// Parity context: the reference's PS hot loop (reference
// distkeras/parameter_servers.py :: SocketParameterServer.run and
// distkeras/networking.py :: send_data/recv_data) served every worker from
// Python handler threads that pickled/unpickled the full weight set per
// round-trip while holding the GIL — SURVEY.md §3.3 calls the server-side
// loop "GIL-contended" and names it the scalability choke point. This file
// is the rebuild's native equivalent for the genuinely-asynchronous
// parameter-server backend (ps_transport="native"): a C++ TCP service whose
// commit fold is a vectorized saxpy on a contiguous float32 center, with no
// interpreter, no pickle, and no GIL anywhere on the wire path. The Python
// side (native_ps.py) only flattens pytrees to one f32 vector
// at the boundary.
//
// Fold semantics are the SAME linear forms MergeRule.fold defines
// (parallel/merge_rules.py): every built-in rule folds one
// commit as center += scale * commit, where
//   ADAG                 scale = 1 / num_workers
//   DOWNPOUR / elastic   scale = 1
//   DynSGD               scale = 1 / (tau + 1), tau = center updates since
//                        that worker's last pull (tracked here, per worker)
// so MODE_FIXED covers the first three and MODE_INV_STALENESS the last.
//
// Wire protocol (little-endian, fixed-size frames — the payload length is
// pinned by the handshake, so a hostile frame can never trigger an
// attacker-sized allocation):
//   handshake: 6-byte magic "DKPS1\n" + u32 worker_id + u64 n_floats
//              server replies u8 (1 = accepted, 0 = length mismatch)
//   request:   u8 action; 1=PULL, 2=COMMIT (followed by n*4 payload bytes),
//              3=BYE, 4=COMMIT_INT8 (u32 S segments, then S x (u64 len +
//              f32 scale) headers with sum(len) validated == n, then n int8
//              bytes — the compressed-commit wire: 4x fewer payload bytes,
//              dequantized per segment into the fold, matching
//              parallel/compression.py's Int8Codec per-leaf scales),
//              5=PULL_INT8 (compressed-pull wire: the server block-
//              quantizes center+error_feedback in kPullBlock runs with one
//              f32 absmax scale per block and keeps the per-worker
//              quantization residual server-side — DoubleSqueeze-style
//              bidirectional compression, Tang et al. 2019; with int8
//              commits the round-trip moves ~2n bytes instead of 8n),
//              6=HEARTBEAT (u32 cumulative client retry count: renews the
//              worker's liveness lease, auto-registering — protocol parity
//              with the Python PS's "heartbeat" action; a worker whose
//              lease lapses past the server's lease_timeout is EVICTED:
//              counted in stats and its pull_version forgotten, so DynSGD
//              treats a zombie commit as maximally stale; every pull,
//              commit and exchange of a leased worker extends its lease
//              too, without counting a heartbeat),
//              7=COMMIT_SEQ (u64 per-worker seqno + n*4 payload bytes:
//              the retry-safe commit — the server folds each (worker,
//              seq) at most once, so a client replaying a commit whose
//              ACK died cannot double-fold it; parity with the Python
//              PS's "seq"-carrying commit),
//              8=DEREGISTER (clean worker exit: drop the lease without
//              counting an eviction),
//              9=FENCE (u64 epoch: raise the server's fencing epoch —
//              monotone; the failover supervisor's last word to a
//              superseded primary, protocol parity with the Python PS's
//              "fence" action),
//              10=COMMIT_SEQ_E (u64 epoch + u64 seqno + n*4 payload:
//              the failover-safe commit — folded only when the client's
//              fencing epoch matches the server's, so a zombie
//              primary's (or a fenced server's) late folds are rejected
//              instead of absorbed into a superseded history),
//              12=JOIN (elastic live-join admission, parity with the
//              Python PS's "join" action: lease the worker quietly —
//              heartbeats stays a pure heartbeat count — and grow the
//              pool gauge; the joiner's next PULL records its
//              pull_version so DynSGD prices its first commit at the
//              true small tau),
//              13=DRAIN (u8 timeout flag: preemption drain — clean
//              deregister retiring the dedup seqno, plus the elastic
//              counters; timeout=1 records a deadline-lapsed drain),
//              14=EXCHANGE (u8 flags [bit0 seq, bit1 epoch, bit2 int8
//              reply, bit3 lag] + optional u64 epoch + optional u64 seq
//              + n*4 payload: the FUSED commit+pull — one round trip
//              folds the commit and answers with the fresh post-fold
//              center, halving the per-window wire cost of the classic
//              commit-then-pull pair; `lag` prices DynSGD tau from the
//              worker's PREVIOUS pull version, the pipelined worker's
//              honest one-window staleness)
//   reply:     PULL -> u64 center_version + n*4 bytes; COMMIT -> u8 ack;
//              PULL_INT8 -> u64 version + u32 nblocks + nblocks*f32 scales
//              + n int8 bytes; HEARTBEAT -> u8 (1 = renewed, 2 =
//              (re-)registered); COMMIT_SEQ -> u8 (1 = folded, 2 =
//              duplicate, dropped); DEREGISTER -> u8 ack; FENCE -> u8
//              ack + u64 epoch-now; COMMIT_SEQ_E -> u8 (1 = folded, 2 =
//              duplicate, 3 = FENCED — not folded) + u64 server epoch;
//              EXCHANGE -> u8 (1/2/3 as COMMIT_SEQ_E) + u64 server epoch
//              + unless fenced: u64 version + the PULL (or PULL_INT8)
//              reply payload
//
// Concurrency model matches the reference: accept loop + one handler thread
// per connection + one mutex around the center. The difference is what runs
// inside the lock: a memcpy or an auto-vectorized fused multiply-add over
// the flat center, not a Python bytecode loop.

#include <algorithm>
#include <array>
#include <atomic>
#include <cerrno>
#include <cfloat>
#include <chrono>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <ctime>
#include <mutex>
#include <thread>
#include <unordered_map>
#include <unordered_set>
#include <vector>

#include <arpa/inet.h>
#include <fcntl.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <sys/time.h>
#include <unistd.h>

namespace {

constexpr char kMagic[6] = {'D', 'K', 'P', 'S', '1', '\n'};
constexpr int MODE_FIXED = 0;
constexpr int MODE_INV_STALENESS = 1;
// compressed-pull quantization granularity: one f32 scale per 1024 values
// (scale overhead 4/4096 of the int8 payload; fine enough that a block's
// absmax never couples distant layers the way a whole-vector scale would)
constexpr uint64_t kPullBlock = 1024;

inline uint64_t pull_blocks(uint64_t n) {
  return (n + kPullBlock - 1) / kPullBlock;
}

// ---------------------------------------------------------------- crc32 --
// zlib-compatible CRC-32 (poly 0xEDB88320), slice-by-8: the payload hash
// runs once per durable commit OFF the center mutex, so it only needs to
// be fast enough not to dominate the handler thread (~1 B/cycle here).
// Python's zlib.crc32 verifies these frames on replay — same polynomial,
// same init/xorout, so the two sides agree bit-for-bit.
struct Crc32Tables {
  uint32_t t[8][256];
  Crc32Tables() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k)
        c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      t[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; ++i)
      for (int j = 1; j < 8; ++j)
        t[j][i] = (t[j - 1][i] >> 8) ^ t[0][t[j - 1][i] & 0xFF];
  }
};
const Crc32Tables kCrc;

uint32_t crc32_buf(const void* data, size_t len, uint32_t seed = 0) {
  const unsigned char* p = static_cast<const unsigned char*>(data);
  uint32_t c = ~seed;
  while (len >= 8) {
    uint32_t lo, hi;
    std::memcpy(&lo, p, 4);
    std::memcpy(&hi, p + 4, 4);
    c ^= lo;
    c = kCrc.t[7][c & 0xFF] ^ kCrc.t[6][(c >> 8) & 0xFF] ^
        kCrc.t[5][(c >> 16) & 0xFF] ^ kCrc.t[4][c >> 24] ^
        kCrc.t[3][hi & 0xFF] ^ kCrc.t[2][(hi >> 8) & 0xFF] ^
        kCrc.t[1][(hi >> 16) & 0xFF] ^ kCrc.t[0][hi >> 24];
    p += 8;
    len -= 8;
  }
  while (len--) c = kCrc.t[0][(c ^ *p++) & 0xFF] ^ (c >> 8);
  return ~c;
}

// -------------------------------------------------------------- adler32 --
// zlib-compatible Adler-32 for the O(model) WAL payload checksum (the
// fixed-size prefixes keep CRC-32). On the 1-hash-pass-per-durable-commit
// hot path the checksum IS the cost: slice-by-8 CRC runs ~1 B/cycle,
// while the SSSE3 maddubs formulation below runs ~5 B/cycle — and
// Python's zlib.adler32 verifies the same value on replay. Weaker mixing
// than CRC is fine for the job here (detecting torn/partial tails).
constexpr uint32_t kAdlerMod = 65521;
constexpr size_t kAdlerNMax = 5552;  // max bytes before the deferred mod

uint32_t adler32_scalar(const uint8_t* p, size_t len, uint32_t seed) {
  uint32_t a = seed & 0xFFFF, b = seed >> 16;
  while (len) {
    size_t n = len < kAdlerNMax ? len : kAdlerNMax;
    len -= n;
    for (size_t i = 0; i < n; ++i) {
      a += p[i];
      b += a;
    }
    p += n;
    a %= kAdlerMod;
    b %= kAdlerMod;
  }
  return (b << 16) | a;
}

#if defined(__x86_64__) || defined(__i386__)
#include <immintrin.h>
__attribute__((target("ssse3"))) uint32_t adler32_ssse3(const uint8_t* p,
                                                        size_t len,
                                                        uint32_t seed) {
  uint32_t a = seed & 0xFFFF, b = seed >> 16;
  const __m128i zero = _mm_setzero_si128();
  const __m128i weights =
      _mm_setr_epi8(16, 15, 14, 13, 12, 11, 10, 9, 8, 7, 6, 5, 4, 3, 2, 1);
  const __m128i ones16 = _mm_set1_epi16(1);
  while (len >= 16) {
    size_t blocks = len / 16;
    if (blocks > kAdlerNMax / 16) blocks = kAdlerNMax / 16;
    // accumulators stay < 2^32 for <= 347 blocks (worst case ~3.92e9)
    __m128i vs2 = zero;   // weighted contributions to b
    __m128i vsum = zero;  // plain byte sum so far in this run
    const uint32_t a0 = a;
    for (size_t i = 0; i < blocks; ++i) {
      const __m128i chunk =
          _mm_loadu_si128(reinterpret_cast<const __m128i*>(p));
      p += 16;
      vs2 = _mm_add_epi32(vs2, _mm_slli_epi32(vsum, 4));
      const __m128i mad = _mm_maddubs_epi16(chunk, weights);
      vs2 = _mm_add_epi32(vs2, _mm_madd_epi16(mad, ones16));
      vsum = _mm_add_epi32(vsum, _mm_sad_epu8(chunk, zero));
    }
    alignas(16) uint32_t t[4];
    _mm_store_si128(reinterpret_cast<__m128i*>(t), vsum);
    const uint32_t sum = t[0] + t[2];  // sad lands in lanes 0 and 2
    _mm_store_si128(reinterpret_cast<__m128i*>(t), vs2);
    const uint32_t s2 = t[0] + t[1] + t[2] + t[3];
    const uint32_t nbytes = static_cast<uint32_t>(blocks * 16);
    b = (b + nbytes * a0 + s2) % kAdlerMod;
    a = (a0 + sum) % kAdlerMod;
    len -= blocks * 16;
  }
  return len ? adler32_scalar(p, len, (b << 16) | a) : (b << 16) | a;
}
#endif

uint32_t adler32_buf(const void* data, size_t len) {
  const uint8_t* p = static_cast<const uint8_t*>(data);
#if defined(__x86_64__) || defined(__i386__)
  static const bool ssse3 = __builtin_cpu_supports("ssse3");
  if (ssse3) return adler32_ssse3(p, len, 1);
#endif
  return adler32_scalar(p, len, 1);
}

// WAL record types shared with resilience/wal.py (the flat, pickle-free
// family — Python's iter_records/replay_record decode them natively)
constexpr uint8_t REC_COMMIT_FLAT = 7;
constexpr uint8_t REC_PULL_FLAT = 8;
constexpr uint8_t REC_DEREG_FLAT = 9;
constexpr uint8_t REC_EVICT_FLAT = 10;
constexpr uint8_t REC_FENCE_FLAT = 11;
// frame header matches wal._HDR (">BII": type, crc32, len — BIG-endian)
constexpr size_t kWalHdr = 9;
// flat-commit prefix matches wal._CMTF ("<IqQQfI", packed little-endian):
// wid u32, seq i64 (-1 = none), pull_version u64, version u64,
// fold-scale f32, adler32(payload) u32
constexpr size_t kCmtPrefix = 36;

void put_hdr(char* out, uint8_t type, uint32_t crc, uint32_t len) {
  out[0] = static_cast<char>(type);
  uint32_t be_crc = __builtin_bswap32(crc);
  uint32_t be_len = __builtin_bswap32(len);
  std::memcpy(out + 1, &be_crc, 4);
  std::memcpy(out + 5, &be_len, 4);
}

// ---------------------------------------------------------------------------
// Shared-memory ring lane (parity with shm.py).
//
// A segment (created and owned by the Python wrapper, layout shared with
// the Python transport's header) carries two SPSC byte pipes: head/tail
// are monotonic u64 byte counters on their own cache lines, the writer
// owns head, the reader owns tail, and closed flags wake a blocked peer.
// The native wire protocol is already self-framing, so the rings move its
// exact frame bytes — no record layer: the whole TCP handler and client
// run UNCHANGED over a ring by representing a channel as a NEGATIVE fd
// (-2, -3, …) that send_all/recv_all dispatch on. Wakeup is a short
// relax-spin, then yields, then 50 µs sleeps (no GIL here, so spinning is
// safe and the common wake is sub-microsecond); client-side ops honour
// the same timeout_ms knob as SO_RCVTIMEO on the socket lane.
constexpr uint64_t kShmHdrBytes = 4096;
constexpr size_t kShmOffC2SHead = 64;
constexpr size_t kShmOffC2STail = 128;
constexpr size_t kShmOffS2CHead = 192;
constexpr size_t kShmOffS2CTail = 256;
constexpr size_t kShmOffClientClosed = 384;
constexpr size_t kShmOffServerClosed = 448;

struct ShmRing {
  std::atomic<uint64_t>* head = nullptr;
  std::atomic<uint64_t>* tail = nullptr;
  char* data = nullptr;
  uint64_t cap = 0;
};

struct ShmChan {
  ShmRing rx, tx;
  std::atomic<uint64_t>* my_closed = nullptr;
  std::atomic<uint64_t>* peer_closed = nullptr;
  std::atomic<int> timeout_ms{0};
};

// channels are registered once and retired by their closed flag — slots
// are never reused (bounded: one per connection; 4096 is far above any
// real colocated worker count and a leak of ~100 B per retired slot)
constexpr int kShmMaxChans = 4096;
ShmChan* g_shm_chans[kShmMaxChans];
std::atomic<int> g_shm_nchans{0};
std::mutex g_shm_mu;

inline ShmChan* shm_chan(int fd) { return g_shm_chans[-fd - 2]; }

// register one endpoint over an already-mapped segment; returns the
// pseudo-fd (< 0) or 0 when the channel table is full
int shm_register(void* base, uint64_t bytes, bool server_side) {
  if (bytes <= kShmHdrBytes) return 0;
  const uint64_t cap = (bytes - kShmHdrBytes) / 2;
  char* b = static_cast<char*>(base);
  auto at = [&](size_t off) {
    return reinterpret_cast<std::atomic<uint64_t>*>(b + off);
  };
  auto* ch = new ShmChan();
  ShmRing c2s{at(kShmOffC2SHead), at(kShmOffC2STail), b + kShmHdrBytes,
              cap};
  ShmRing s2c{at(kShmOffS2CHead), at(kShmOffS2CTail),
              b + kShmHdrBytes + cap, cap};
  if (server_side) {
    ch->rx = c2s;
    ch->tx = s2c;
    ch->my_closed = at(kShmOffServerClosed);
    ch->peer_closed = at(kShmOffClientClosed);
  } else {
    ch->rx = s2c;
    ch->tx = c2s;
    ch->my_closed = at(kShmOffClientClosed);
    ch->peer_closed = at(kShmOffServerClosed);
  }
  std::lock_guard<std::mutex> g(g_shm_mu);
  const int idx = g_shm_nchans.load(std::memory_order_relaxed);
  if (idx >= kShmMaxChans) {
    delete ch;
    return 0;
  }
  g_shm_chans[idx] = ch;
  g_shm_nchans.store(idx + 1, std::memory_order_release);
  return -(idx + 2);
}

inline bool shm_closed(ShmChan* ch) {
  return ch->my_closed->load(std::memory_order_relaxed) ||
         ch->peer_closed->load(std::memory_order_relaxed);
}

// spin-then-wait backoff: relax-spin first (the peer is usually mid-copy
// on another core), then yield, then bounded sleeps
struct ShmWaiter {
  int spins = 0;
  std::chrono::steady_clock::time_point deadline{};
  bool bounded = false;
  explicit ShmWaiter(int timeout_ms) {
    if (timeout_ms > 0) {
      bounded = true;
      deadline = std::chrono::steady_clock::now() +
                 std::chrono::milliseconds(timeout_ms);
    }
  }
  // returns false when the (client-side) timeout lapsed
  bool pause() {
    ++spins;
    if (spins < 256) {
      // plain relax iteration; the load in the caller's loop is the wait
    } else if (spins < 1024) {
      std::this_thread::yield();
    } else {
      std::this_thread::sleep_for(std::chrono::microseconds(50));
      if (bounded && std::chrono::steady_clock::now() >= deadline)
        return false;
    }
    return true;
  }
};

bool shm_send_chan(ShmChan* ch, const void* buf, size_t n) {
  const char* p = static_cast<const char*>(buf);
  ShmRing& r = ch->tx;
  uint64_t head = r.head->load(std::memory_order_relaxed);
  ShmWaiter w(ch->timeout_ms.load(std::memory_order_relaxed));
  while (n) {
    const uint64_t tail = r.tail->load(std::memory_order_acquire);
    const uint64_t free_b = r.cap - (head - tail);
    if (free_b == 0) {
      if (shm_closed(ch)) return false;
      if (!w.pause()) return false;
      continue;
    }
    const uint64_t pos = head % r.cap;
    uint64_t k = n;
    if (k > free_b) k = free_b;
    if (k > r.cap - pos) k = r.cap - pos;
    std::memcpy(r.data + pos, p, k);
    head += k;
    r.head->store(head, std::memory_order_release);
    p += k;
    n -= static_cast<size_t>(k);
    w.spins = 0;
  }
  return true;
}

bool shm_recv_chan(ShmChan* ch, void* buf, size_t n) {
  char* p = static_cast<char*>(buf);
  ShmRing& r = ch->rx;
  uint64_t tail = r.tail->load(std::memory_order_relaxed);
  ShmWaiter w(ch->timeout_ms.load(std::memory_order_relaxed));
  while (n) {
    const uint64_t head = r.head->load(std::memory_order_acquire);
    const uint64_t avail = head - tail;
    if (avail == 0) {
      // drain-before-fail: buffered bytes stay readable past a close
      if (shm_closed(ch)) return false;
      if (!w.pause()) return false;
      continue;
    }
    const uint64_t pos = tail % r.cap;
    uint64_t k = n;
    if (k > avail) k = avail;
    if (k > r.cap - pos) k = r.cap - pos;
    std::memcpy(p, r.data + pos, k);
    tail += k;
    r.tail->store(tail, std::memory_order_release);
    p += k;
    n -= static_cast<size_t>(k);
    w.spins = 0;
  }
  return true;
}

// connection close that understands both lanes: a ring peer is woken by
// the closed flag (its next wait observes it), a socket is closed
void close_conn_fd(int fd) {
  if (fd < 0) {
    shm_chan(fd)->my_closed->store(1, std::memory_order_release);
    return;
  }
  ::close(fd);
}

void shutdown_conn_fd(int fd) {
  if (fd < 0) {
    shm_chan(fd)->my_closed->store(1, std::memory_order_release);
    return;
  }
  ::shutdown(fd, SHUT_RDWR);
}

bool send_all(int fd, const void* buf, size_t n) {
  if (fd < 0) return shm_send_chan(shm_chan(fd), buf, n);
  const char* p = static_cast<const char*>(buf);
  while (n) {
    ssize_t k = ::send(fd, p, n, MSG_NOSIGNAL);
    if (k <= 0) {
      if (k < 0 && errno == EINTR) continue;
      return false;
    }
    p += k;
    n -= static_cast<size_t>(k);
  }
  return true;
}

bool recv_all(int fd, void* buf, size_t n) {
  if (fd < 0) return shm_recv_chan(shm_chan(fd), buf, n);
  char* p = static_cast<char*>(buf);
  while (n) {
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

void set_nodelay(int fd) {
  if (fd < 0) return;  // ring lane: no socket options to set
  int one = 1;
  ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
}

struct Server {
  std::vector<float> center;
  // Polyak/EMA of the center, updated per commit when ema_decay >= 0
  // (negative = off) — same semantics as the Python PS's get_ema()
  std::vector<float> ema;
  double ema_decay = -1.0;
  uint64_t n = 0;
  int mode = MODE_FIXED;
  double fixed_scale = 1.0;
  std::mutex mu;
  uint64_t num_updates = 0;
  std::unordered_map<uint32_t, uint64_t> pull_versions;
  // The PREVIOUS recorded pull version per worker: every
  // pull-version record shifts cur -> prev. A pipelined fused EXCHANGE
  // (action 14, lag flag) prices DynSGD tau from prev — the delta it
  // commits was computed from the center returned one exchange ago, and
  // that deliberate extra window of staleness must be priced. Under mu;
  // replay reconstructs it with the identical shift rule.
  std::unordered_map<uint32_t, uint64_t> prev_pull_versions;
  // Per-worker compressed-pull quantization residual (error feedback): the
  // part of center+e the int8 wire dropped, re-added to that worker's next
  // compressed pull so its received stream telescopes to the true center
  // stream. Sized lazily on a worker's first PULL_INT8; exact pulls and
  // workers that never compress cost nothing. Each worker's state carries
  // its OWN mutex: quantization runs outside the center lock so different
  // workers' pulls overlap, but a reconnecting client reusing a worker id
  // while the old handler is mid-quantize must serialize against it, not
  // race on the shared residual (map nodes are reference-stable, so the
  // struct address stays valid across other workers' insertions).
  struct PullErr {
    std::mutex m;
    std::vector<float> err;
  };
  std::unordered_map<uint32_t, PullErr> pull_errors;

  // Per-worker last APPLIED commit seqno (COMMIT_SEQ dedup) — under mu,
  // probed once per seq'd commit, so the fold's critical section stays
  // O(fold) + O(1).
  std::unordered_map<uint32_t, uint64_t> last_seq;

  // Liveness leases (HEARTBEAT/DEREGISTER; parity with the Python PS's
  // resilience/heartbeat.py registry): renewed by heartbeats, scanned
  // lazily (rate-limited to a quarter lease) under their OWN mutex —
  // never while holding mu; eviction then takes mu to forget the dead
  // worker's pull_version (zombie commits read as maximally stale).
  struct Lease {
    uint64_t deadline_ns = 0;
    uint64_t renewals = 0;
  };
  double lease_timeout_s = 30.0;
  std::mutex lease_mu;
  std::unordered_map<uint32_t, Lease> leases;
  uint64_t next_expiry_ns = 0;            // under lease_mu
  // Latest cumulative client-reported retry count per worker id, kept
  // across lease lifecycles (clients report running totals; folding into
  // a sum at eviction would double-count after re-admission). Under
  // lease_mu; summed at stats time.
  std::unordered_map<uint32_t, uint32_t> retries_by_wid;
  std::atomic<uint64_t> st_heartbeats{0}, st_evicted{0}, st_dups{0};

  // Fencing epoch (protocol parity with the Python PS / resilience
  // failover): COMMIT_SEQ_E folds only when the client's epoch matches;
  // FENCE raises it monotonically. Under mu (checked inside the fold's
  // critical section — one integer compare).
  uint64_t fence_epoch = 0;
  std::atomic<uint64_t> st_fenced{0};

  // Shard-map handshake (the sharding layer): which shard of an
  // N-shard center this server holds. num_shards == 0 means unsharded
  // (the default — SHARD_INFO then reports "no shard record", exactly
  // like the Python server's shard_info = None). Atomics: set once by
  // dkps_server_set_shard before traffic, read per SHARD_INFO request.
  std::atomic<uint32_t> shard_id{0};
  std::atomic<uint32_t> num_shards{0};

  // Elastic-membership accounting (resilience/elastic.py; parity with
  // the Python PS's join_worker/drain_worker): the pool gauge starts at
  // the configured worker count (dkps_server_set_pool_size) and tracks
  // joins minus drains; the other three are lifetime totals. Telemetry,
  // not durable state — like the op counters they restart on recovery.
  std::atomic<int64_t> st_pool{0};
  std::atomic<uint64_t> st_joined{0}, st_preempted{0}, st_drain_to{0};
  // join/drain idempotence (under lease_mu; parity with the Python PS):
  // a lost-ACK replay of the JOIN/DRAIN wire action must not
  // double-count the membership event. A wid's join counts once until
  // it drains, its drain once until it re-joins; eviction clears both.
  std::unordered_set<uint32_t> joined_wids, drained_wids;

  // -- write-ahead log with GROUP COMMIT (same frame format as
  // resilience/wal.py, so Python's recover_ps_state replays a native-
  // written log bit-identically). Appends run under the center mutex —
  // fold order IS log order — but only memcpy pre-encoded bytes into the
  // in-memory `pending` buffer; the flusher thread batches a window of
  // commits onto ONE write+fsync and wakes every waiter at once. Commit
  // handlers defer their ACK until their record is durable (wal_wait),
  // so ACK => fsync'd — the strongest durability this file has ever had,
  // at ~1/window the sync cost. window 0 = time-bounded async (no ACK
  // deferral; fsync at least every interval_s — the quiet-period bound).
  struct WalRec {
    char head[kWalHdr + kCmtPrefix];  // header + (for commits) prefix
    uint32_t head_len = 0;
    // commit payloads are logged ZERO-COPY in the deferred-ACK modes:
    // `payload` points into the handler's scratch buffer, which stays
    // alive because the handler blocks in wal_wait until this record is
    // durable (and a crash clears the queue before waking it). Window 0
    // (no wait) copies into `owned` instead.
    const char* payload = nullptr;
    size_t payload_len = 0;
    std::vector<char> owned;
  };
  struct Wal {
    int fd = -1;
    uint64_t window = 8;
    double interval_s = 0.25;
    std::mutex wmu;  // guards the queue/counters; taken AFTER mu, never
                     // the other way (the flusher takes wmu only)
    std::mutex io_mu;  // serializes writers (flusher / close); appenders
                       // never take it — the fold path can't block on I/O
    std::condition_variable cv;
    std::vector<WalRec> queue;
    uint64_t appended = 0, durable = 0;
    uint64_t commits_appended = 0, commits_durable = 0;
    uint64_t queued_bytes = 0;
    uint64_t waiters = 0;
    bool running = false, abandoned = false;
    std::chrono::steady_clock::time_point first_pending{};
    bool has_pending = false;
    std::thread flusher;
    std::atomic<uint64_t> st_records{0}, st_fsyncs{0}, st_group_max{0};
  };
  Wal wal;
  bool wal_on = false;  // set before start(), read-only afterwards

  // queue one encoded record — call under mu (log order == fold order);
  // takes wmu internally. O(1) in the payload when `copy` is false (the
  // deferred-ACK modes): the queue holds a POINTER into the caller's
  // buffer, pinned by the caller's wal_wait. Returns the wait token.
  uint64_t wal_append_locked(const char* head, size_t head_len,
                             const void* payload, size_t payload_len,
                             bool commit, bool copy) {
    std::lock_guard<std::mutex> g(wal.wmu);
    wal.queue.emplace_back();
    WalRec& r = wal.queue.back();
    std::memcpy(r.head, head, head_len);
    r.head_len = static_cast<uint32_t>(head_len);
    if (payload_len) {
      const char* pay = static_cast<const char*>(payload);
      if (copy) {
        r.owned.assign(pay, pay + payload_len);
        r.payload = r.owned.data();
      } else {
        r.payload = pay;
      }
      r.payload_len = payload_len;
    }
    wal.appended += 1;
    wal.queued_bytes += head_len + payload_len;
    wal.st_records += 1;
    if (commit) wal.commits_appended += 1;
    if (!wal.has_pending) {
      wal.has_pending = true;
      wal.first_pending = std::chrono::steady_clock::now();
    }
    wal.cv.notify_all();
    return wal.appended;
  }

  // `staged`: window-0 callers pre-copy the payload bytes OFF the center
  // mutex (they never wal_wait, so the queue can't reference their
  // receive buffer) and hand ownership here; window >= 1 callers pass
  // nullptr and the queue references `payload` zero-copy — the handler
  // blocks in wal_wait before reusing it. Either way the critical
  // section stays O(1) in the payload size.
  uint64_t wal_append_commit_locked(uint32_t wid, int64_t seq, uint64_t pv,
                                    uint64_t version, float scale,
                                    const float* payload, uint64_t count,
                                    uint32_t payload_crc,
                                    std::vector<char>* staged) {
    char head[kWalHdr + kCmtPrefix];
    char* prefix = head + kWalHdr;
    std::memcpy(prefix + 0, &wid, 4);
    std::memcpy(prefix + 4, &seq, 8);
    std::memcpy(prefix + 12, &pv, 8);
    std::memcpy(prefix + 20, &version, 8);
    std::memcpy(prefix + 28, &scale, 4);
    std::memcpy(prefix + 32, &payload_crc, 4);
    put_hdr(head, REC_COMMIT_FLAT, crc32_buf(prefix, kCmtPrefix),
            static_cast<uint32_t>(kCmtPrefix + count * 4));
    if (staged != nullptr)
      return wal_append_owned_locked(head, sizeof(head), staged,
                                     /*commit=*/true);
    return wal_append_locked(head, sizeof(head), payload, count * 4,
                             /*commit=*/true, /*copy=*/false);
  }

  // take ownership of a pre-staged payload vector (O(1) move under mu)
  uint64_t wal_append_owned_locked(const char* head, size_t head_len,
                                   std::vector<char>* staged, bool commit) {
    std::lock_guard<std::mutex> g(wal.wmu);
    wal.queue.emplace_back();
    WalRec& r = wal.queue.back();
    std::memcpy(r.head, head, head_len);
    r.head_len = static_cast<uint32_t>(head_len);
    r.owned = std::move(*staged);
    r.payload = r.owned.data();
    r.payload_len = r.owned.size();
    wal.appended += 1;
    wal.queued_bytes += head_len + r.payload_len;
    wal.st_records += 1;
    if (commit) wal.commits_appended += 1;
    if (!wal.has_pending) {
      wal.has_pending = true;
      wal.first_pending = std::chrono::steady_clock::now();
    }
    wal.cv.notify_all();
    return wal.appended;
  }

  uint64_t wal_append_small_locked(uint8_t type, const char* body,
                                   size_t len) {
    // small control records (pull/dereg/evict/fence) are copied into the
    // queue — their stack bodies die with this call. An evict body can
    // exceed the fixed head buffer, so it rides the owned-payload slot.
    char head[kWalHdr + kCmtPrefix];
    put_hdr(head, type, crc32_buf(body, len), static_cast<uint32_t>(len));
    return wal_append_locked(head, kWalHdr, body, len,
                             /*commit=*/false, /*copy=*/true);
  }

  void wal_append_pull_locked(uint32_t wid, uint64_t version) {
    char body[12];
    std::memcpy(body + 0, &wid, 4);
    std::memcpy(body + 4, &version, 8);
    wal_append_small_locked(REC_PULL_FLAT, body, sizeof(body));
  }

  uint64_t wal_append_fence_locked(uint64_t epoch) {
    char body[8];
    std::memcpy(body, &epoch, 8);
    return wal_append_small_locked(REC_FENCE_FLAT, body, sizeof(body));
  }

  void wal_append_dereg_locked(uint32_t wid) {
    char body[4];
    std::memcpy(body, &wid, 4);
    wal_append_small_locked(REC_DEREG_FLAT, body, sizeof(body));
  }

  void wal_append_evict_locked(const std::vector<uint32_t>& wids) {
    std::vector<char> body(4 + wids.size() * 4);
    uint32_t count = static_cast<uint32_t>(wids.size());
    std::memcpy(body.data(), &count, 4);
    for (size_t i = 0; i < wids.size(); ++i)
      std::memcpy(body.data() + 4 + i * 4, &wids[i], 4);
    wal_append_small_locked(REC_EVICT_FLAT, body.data(), body.size());
  }

  // block until record `token` is fsync'd (the deferred ACK). False =
  // the log was abandoned (crash seam) — the caller skips its ACK; the
  // client never hears back and replays, the dedup table folds it once.
  // A zero-copy record's payload buffer is pinned exactly as long as its
  // appender sits here: the flusher's drain writes it BEFORE durability
  // advances, and a crash clears the queue BEFORE `abandoned` wakes us.
  bool wal_wait(uint64_t token) {
    std::unique_lock<std::mutex> lk(wal.wmu);
    wal.waiters += 1;
    wal.cv.notify_all();  // the flusher syncs eagerly for waiters
    while (wal.durable < token && !wal.abandoned)
      wal.cv.wait_for(lk, std::chrono::milliseconds(100));
    wal.waiters -= 1;
    return wal.durable >= token;
  }

  // drain the queue → write → fsync → publish durability. Writers
  // (flusher, wal_close) serialize on io_mu; appenders never take it.
  bool wal_drain_and_sync() {
    std::lock_guard<std::mutex> io(wal.io_mu);
    std::vector<WalRec> batch;
    uint64_t upto, upto_commits;
    {
      std::lock_guard<std::mutex> g(wal.wmu);
      if (wal.abandoned || wal.fd < 0) return false;
      batch.swap(wal.queue);
      upto = wal.appended;
      upto_commits = wal.commits_appended;
      wal.queued_bytes = 0;
      wal.has_pending = false;
    }
    // the group-fsync span (flusher thread): the segment every
    // deferred-ACK commit's TK_WAL_WAIT span ends on. No worker/seq —
    // one fsync serves a whole window.
    const uint64_t t_sync = trace_t0();
    bool ok = true;
    for (const WalRec& r : batch) {
      const char* parts[2] = {r.head, r.payload};
      const size_t lens[2] = {r.head_len, r.payload_len};
      for (int i = 0; i < 2 && ok; ++i) {
        const char* p = parts[i];
        size_t left = lens[i];
        while (left) {
          ssize_t k = ::write(wal.fd, p, left);
          if (k < 0) {
            if (errno == EINTR) continue;
            ok = false;
            break;
          }
          p += k;
          left -= static_cast<size_t>(k);
        }
      }
      if (!ok) break;
    }
    if (ok && ::fsync(wal.fd) != 0) ok = false;
    {
      std::lock_guard<std::mutex> g(wal.wmu);
      if (ok) {
        uint64_t group = upto_commits - wal.commits_durable;
        uint64_t prev = wal.st_group_max.load();
        if (group > prev) wal.st_group_max = group;
        wal.durable = std::max(wal.durable, upto);
        wal.commits_durable = std::max(wal.commits_durable, upto_commits);
        wal.st_fsyncs += 1;
      } else {
        // a write/fsync that cannot succeed would strand waiters (and
        // their pinned buffers) forever: abandon instead — clients see
        // no ACK and replay against whatever IS durable
        wal.abandoned = true;
      }
      wal.cv.notify_all();
    }
    trace_rec(TK_FSYNC, 0xffffffffull, 0, t_sync);
    return ok;
  }

  void wal_flush_loop() {
    for (;;) {
      {
        std::unique_lock<std::mutex> lk(wal.wmu);
        for (;;) {
          if (!wal.running) return;
          if (!wal.queue.empty() && !wal.abandoned) {
            const double age =
                wal.has_pending
                    ? std::chrono::duration<double>(
                          std::chrono::steady_clock::now() -
                          wal.first_pending)
                          .count()
                    : 0.0;
            const uint64_t pending_commits =
                wal.commits_appended - wal.commits_durable;
            if (wal.waiters > 0 ||
                (wal.window >= 1 && pending_commits >= wal.window) ||
                wal.queued_bytes >= (64u << 20) || age >= wal.interval_s)
              break;
          }
          wal.cv.wait_for(
              lk, std::chrono::duration<double>(wal.interval_s));
        }
      }
      wal_drain_and_sync();
    }
  }

  // clean shutdown: drain + fsync + close (a CRASH uses wal_abandon).
  // Handlers blocked in wal_wait were released by the still-running
  // flusher before the server joined them — only no-waiter records
  // (pulls, window-0 commits) can still sit in the queue here.
  void wal_close() {
    if (!wal_on) return;
    bool was_abandoned;
    {
      std::lock_guard<std::mutex> g(wal.wmu);
      was_abandoned = wal.abandoned;
    }
    if (!was_abandoned) wal_drain_and_sync();
    {
      std::lock_guard<std::mutex> g(wal.wmu);
      wal.running = false;
      wal.cv.notify_all();
    }
    if (wal.flusher.joinable()) wal.flusher.join();
    std::lock_guard<std::mutex> io(wal.io_mu);
    std::lock_guard<std::mutex> g(wal.wmu);
    if (wal.fd >= 0) {
      ::close(wal.fd);
      wal.fd = -1;
    }
    wal.queue.clear();
  }

  // crash seam: lose the queued records (a SIGKILL'd process's user-space
  // bytes) and wake every deferred-ACK waiter to give up. Order matters
  // for the zero-copy payloads: (1) clear the queue and stop the flusher
  // — waiters stay parked, so every buffer a swapped in-flight batch
  // might still reference stays alive; (2) join the flusher; (3) only
  // THEN set `abandoned`, waking waiters whose buffers nothing
  // references anymore; (4) close the fd last, so no write ever lands on
  // a recycled descriptor.
  void wal_abandon() {
    if (!wal_on) return;
    {
      std::lock_guard<std::mutex> g(wal.wmu);
      wal.running = false;  // flusher exits; wal_wait does NOT check this
      wal.queue.clear();
      wal.cv.notify_all();
    }
    if (wal.flusher.joinable()) wal.flusher.join();
    {
      std::lock_guard<std::mutex> g(wal.wmu);
      wal.abandoned = true;
      wal.cv.notify_all();
    }
    std::lock_guard<std::mutex> io(wal.io_mu);
    std::lock_guard<std::mutex> g(wal.wmu);
    if (wal.fd >= 0) {
      ::close(wal.fd);
      wal.fd = -1;
    }
  }

  static uint64_t now_ns() {
    return static_cast<uint64_t>(
        std::chrono::duration_cast<std::chrono::nanoseconds>(
            std::chrono::steady_clock::now().time_since_epoch())
            .count());
  }

  // Evict lapsed leases (rate-limited on the hot path; force=true skips
  // the limiter so observability reads never see a lapsed lease as
  // live). Lock order: lease_mu released BEFORE mu is taken for the
  // pull_version cleanup.
  void expire_leases(bool force = false) {
    const uint64_t now = now_ns();
    std::vector<uint32_t> dead;
    {
      std::lock_guard<std::mutex> g(lease_mu);
      if (!force && now < next_expiry_ns) return;
      const uint64_t every = static_cast<uint64_t>(
          std::max(lease_timeout_s / 4.0, 1e-3) * 1e9);
      next_expiry_ns = now + every;
      for (auto it = leases.begin(); it != leases.end();) {
        if (it->second.deadline_ns < now) {
          dead.push_back(it->first);
          it = leases.erase(it);
        } else {
          ++it;
        }
      }
      for (uint32_t wid : dead) {
        // membership hygiene (parity with the Python _on_evict): an
        // evicted wid's join/drain idempotence records retire with it
        joined_wids.erase(wid);
        drained_wids.erase(wid);
      }
      st_evicted += dead.size();
    }
    if (!dead.empty()) {
      std::lock_guard<std::mutex> g(mu);
      for (uint32_t wid : dead) {
        pull_versions.erase(wid);
        prev_pull_versions.erase(wid);
        // retire the commit-dedup entry too (parity with the Python
        // _on_evict): long elastic runs with many worker generations
        // must not grow last_seq without bound
        last_seq.erase(wid);
      }
      if (wal_on) wal_append_evict_locked(dead);
    }
  }

  // returns true when the lease already existed (a renewal)
  bool heartbeat(uint32_t wid, uint32_t retries) {
    const uint64_t deadline =
        now_ns() + static_cast<uint64_t>(lease_timeout_s * 1e9);
    bool known;
    {
      std::lock_guard<std::mutex> g(lease_mu);
      st_heartbeats += 1;
      auto it = leases.find(wid);
      known = it != leases.end();
      Lease& l = known ? it->second : leases[wid];
      l.deadline_ns = deadline;
      l.renewals += 1;
      if (retries) {
        uint32_t& r = retries_by_wid[wid];
        r = std::max(r, retries);
      }
    }
    expire_leases();
    return known;
  }

  // a request from a leased worker shows it alive: extend its lease (no
  // heartbeat counted, nobody registered) — parity with the port's
  // WorkerRegistry.touch. The handler calls it before it records a pull
  // or folds a commit, so an eviction cannot retire the dedup entry
  // between a fold and the replay of its lost ACK unless the replay
  // itself comes a whole lease later
  void touch(uint32_t wid) {
    const uint64_t deadline =
        now_ns() + static_cast<uint64_t>(lease_timeout_s * 1e9);
    std::lock_guard<std::mutex> g(lease_mu);
    auto it = leases.find(wid);
    if (it != leases.end()) it->second.deadline_ns = deadline;
  }

  void deregister(uint32_t wid) {
    {
      std::lock_guard<std::mutex> g(lease_mu);
      leases.erase(wid);
    }
    // retire the seqno fence too (fresh clients start a new epoch; the
    // fence would only grow the map) — lease_mu released before mu.
    // Pull-version slots (cur AND prev) retire with the clean exit: a
    // same-id successor's first pull must not shift this generation's
    // version into prev, where a lag-priced exchange would read it
    // (parity with the Python deregister_worker).
    std::lock_guard<std::mutex> g(mu);
    last_seq.erase(wid);
    pull_versions.erase(wid);
    prev_pull_versions.erase(wid);
    if (wal_on) wal_append_dereg_locked(wid);
  }

  // elastic live-join (JOIN, action 12): lease the worker QUIETLY (no
  // heartbeat counted — parity with WorkerRegistry.register) and grow
  // the pool gauge. Returns the post-join pool size.
  int64_t join_wid(uint32_t wid) {
    const uint64_t deadline =
        now_ns() + static_cast<uint64_t>(lease_timeout_s * 1e9);
    {
      std::lock_guard<std::mutex> g(lease_mu);
      Lease& l = leases[wid];
      l.deadline_ns = deadline;
      drained_wids.erase(wid);
      if (!joined_wids.insert(wid).second)
        return st_pool.load();  // lost-ACK replay: already counted
    }
    st_joined += 1;
    return st_pool += 1;
  }

  // preemption drain (DRAIN, action 13): a clean deregister plus the
  // elastic counters; timed_out records a deadline-lapsed drain.
  void drain_wid(uint32_t wid, bool timed_out) {
    deregister(wid);
    {
      std::lock_guard<std::mutex> g(lease_mu);
      if (!drained_wids.insert(wid).second)
        return;  // lost-ACK replay: this drain already counted
      joined_wids.erase(wid);
    }
    st_preempted += 1;
    if (timed_out) st_drain_to += 1;
    int64_t pool = st_pool.load();
    while (pool > 0 &&
           !st_pool.compare_exchange_weak(pool, pool - 1)) {
    }
  }

  // Contention/throughput counters (parity with the Python PS's stats():
  // same semantics, read via dkps_server_stats). Atomics: bumped from
  // handler threads, read lock-free by the stats call. Byte counters are
  // PAYLOAD bytes (weights/quantized values + per-segment scale metadata)
  // — the few fixed per-op protocol bytes (action, version, counts) are
  // excluded, matching the Python side's "framing excluded" accounting.
  // Lock wait/hold cover the CENTER mutex's hot-path sections only (pull
  // snapshot, commit fold) — admin reads (get_center etc.) stay
  // unlogged, same as the Python side.
  std::atomic<uint64_t> st_pulls{0}, st_cpulls{0}, st_commits{0};
  std::atomic<uint64_t> st_fused{0};  // fused EXCHANGE ops served
  std::atomic<uint64_t> st_bytes_in{0}, st_bytes_out{0};
  std::atomic<uint64_t> st_lock_acquires{0}, st_lock_wait_ns{0},
      st_lock_hold_ns{0};
  // Delivered-traffic settling: handlers bump this around
  // the reply-send → counter-land window of the pull-side paths;
  // dkps_server_stats waits (bounded) for it to reach zero so an
  // end-of-run stats read sees every delivered reply counted — parity
  // with the Python server's _settle_stats barrier.
  std::atomic<int64_t> st_pending{0};
  struct PendingGuard {
    Server* s;
    explicit PendingGuard(Server* srv) : s(srv) { s->st_pending += 1; }
    ~PendingGuard() { s->st_pending -= 1; }
  };

  // Flight-recorder span ring: fixed-capacity ring of
  // (kind, wid, seq, t0_ns, dur_ns) span records over CLOCK_MONOTONIC —
  // the SAME clock Python's perf_counter_ns reads on Linux, so scraped
  // spans drop into the Python tracer's timeline with no offset
  // arithmetic. Armed by dkps_server_set_trace, DRAINED by the TRACE
  // wire action (15). Off by default: one relaxed atomic load per
  // traced section, nothing else.
  static constexpr size_t kTraceCap = 8192;
  static constexpr uint64_t TK_FOLD = 1, TK_WAL_WAIT = 2, TK_FSYNC = 3;
  std::atomic<bool> trace_on{false};
  std::mutex trace_mu;
  std::vector<std::array<uint64_t, 5>> trace_ring;
  uint64_t trace_head = 0;  // total recorded; ring slot = head % cap

  static uint64_t mono_ns() {
    timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return static_cast<uint64_t>(ts.tv_sec) * 1000000000ull +
           static_cast<uint64_t>(ts.tv_nsec);
  }

  // 0 disables recording at the call site (mono_ns is never 0 after
  // boot): `uint64_t t = trace_t0(); ... trace_rec(kind, w, q, t);`
  uint64_t trace_t0() const {
    return trace_on.load(std::memory_order_relaxed) ? mono_ns() : 0;
  }

  void trace_rec(uint64_t kind, uint64_t wid, uint64_t seq, uint64_t t0) {
    if (t0 == 0) return;
    const uint64_t t1 = mono_ns();
    std::lock_guard<std::mutex> g(trace_mu);
    if (trace_ring.size() < kTraceCap)
      trace_ring.push_back({kind, wid, seq, t0, t1 - t0});
    else
      trace_ring[trace_head % kTraceCap] = {kind, wid, seq, t0, t1 - t0};
    trace_head += 1;
  }

  int listen_fd = -1;
  int port = 0;
  std::atomic<bool> running{false};
  std::thread accept_thread;
  std::mutex conn_mu;
  std::vector<int> conn_fds;
  std::vector<std::thread> handlers;

  // RAII center-mutex guard with wait/hold accounting (steady_clock ns)
  // for the hot-path sections feeding dkps_server_stats
  struct StatGuard {
    Server* s;
    std::chrono::steady_clock::time_point t_acq;
    explicit StatGuard(Server* srv) : s(srv) {
      const auto t0 = std::chrono::steady_clock::now();
      s->mu.lock();
      t_acq = std::chrono::steady_clock::now();
      s->st_lock_wait_ns +=
          std::chrono::duration_cast<std::chrono::nanoseconds>(t_acq - t0)
              .count();
      s->st_lock_acquires += 1;
    }
    ~StatGuard() {
      s->st_lock_hold_ns += std::chrono::duration_cast<
                                std::chrono::nanoseconds>(
                                std::chrono::steady_clock::now() - t_acq)
                                .count();
      s->mu.unlock();
    }
  };

  // Block-quantize center snapshot `c` plus the worker's EF residual
  // `err` (updated in place) into qbuf/pscales — the ONE int8 pull
  // encode, shared by PULL_INT8 and the fused EXCHANGE reply so the two
  // wires cannot drift on the tie rule, the subnormal guard, or the
  // residual math. Call under the worker's PullErr mutex.
  void encode_int8_blocks(const float* c, std::vector<float>& err,
                          std::vector<int8_t>& qbuf,
                          std::vector<float>& pscales) {
    const uint64_t nb = pull_blocks(n);
    if (err.size() != n) err.assign(n, 0.0f);
    for (uint64_t b = 0; b < nb; ++b) {
      const uint64_t lo = b * kPullBlock;
      const uint64_t hi = std::min(lo + kPullBlock, n);
      float amax = 0.0f;
      for (uint64_t i = lo; i < hi; ++i) {
        const float v = c[i] + err[i];
        err[i] = v;  // stage v; residual subtracted below
        const float a = v < 0 ? -v : v;
        amax = a > amax ? a : amax;
      }
      const float scale = amax > 0 ? amax / 127.0f : 0.0f;
      pscales[b] = scale;
      // Subnormal-scale guard (parity with the Python encode's
      // degenerate path): for a tiny block, 1/scale overflows to inf
      // and a zero element would make qf = 0·inf = NaN, which the
      // clamp passes through into an undefined int8 cast. Sending
      // zeros keeps the whole block in the residual instead — the EF
      // stream still telescopes, with defined behavior.
      const float inv = scale >= FLT_MIN ? 1.0f / scale : 0.0f;
      for (uint64_t i = lo; i < hi; ++i) {
        const float v = err[i];
        float qf = v * inv;
        qf = qf < -127.0f ? -127.0f : (qf > 127.0f ? 127.0f : qf);
        // branchless round-half-away (std::lround is a per-element
        // libm call that blocks auto-vectorization; EF absorbs the
        // half-ulp tie-rule difference vs rint)
        qf += qf >= 0.0f ? 0.5f : -0.5f;
        const int8_t q = static_cast<int8_t>(qf);
        qbuf[i] = q;
        err[i] = v - scale * static_cast<float>(q);
      }
    }
  }

  // Undo one encode whose reply never reached the client: restore
  // err_old = v − c from err = v − scale·q (qbuf/pscales/c must be
  // exactly what the encode saw). Without this, a reconnecting worker's
  // EF stream would silently absorb one phantom pull — bounded (≤ half
  // a step per element) but avoidable. Same PullErr mutex as the encode.
  void rollback_int8_blocks(const float* c, std::vector<float>& err,
                            const std::vector<int8_t>& qbuf,
                            const std::vector<float>& pscales) {
    const uint64_t nb = pull_blocks(n);
    for (uint64_t b = 0; b < nb; ++b) {
      const uint64_t lo = b * kPullBlock;
      const uint64_t hi = std::min(lo + kPullBlock, n);
      const float scale = pscales[b];
      for (uint64_t i = lo; i < hi; ++i)
        err[i] += scale * static_cast<float>(qbuf[i]) - c[i];
    }
  }

  // EMA fold after a commit landed in the center — call under mu
  void ema_fold_locked() {
    if (ema_decay < 0) return;
    const float d = static_cast<float>(ema_decay);
    const float od = 1.0f - d;
    float* e = ema.data();
    const float* c = center.data();
    for (uint64_t i = 0; i < n; ++i) e[i] = d * e[i] + od * c[i];
  }

  // conn_wid_'s recorded pull version (0 = never pulled) — call under mu
  uint64_t pull_version_locked() {
    auto it = pull_versions.find(conn_wid_);
    return it != pull_versions.end() ? it->second : 0;
  }

  // the pull version one commit from conn_wid_ is priced from — call
  // under mu. `lag` (the pipelined fused exchange) reads the PREVIOUS
  // recorded version, falling back to the current one when no previous
  // record exists yet (a worker's first exchange after its initial pull,
  // or after a recovery that predates its prev record).
  uint64_t priced_pv_locked(bool lag) {
    if (lag) {
      auto it = prev_pull_versions.find(conn_wid_);
      if (it != prev_pull_versions.end()) return it->second;
    }
    auto it = pull_versions.find(conn_wid_);
    return it != pull_versions.end() ? it->second : 0;
  }

  float scale_from_pv_locked(uint64_t pv) {
    if (mode != MODE_INV_STALENESS) return static_cast<float>(fixed_scale);
    uint64_t tau = num_updates - pv;
    return static_cast<float>(1.0 / (static_cast<double>(tau) + 1.0));
  }

  // record conn_wid_'s pull version at the current update count, with
  // the cur -> prev shift every pull-version record performs — call
  // under mu (PULL, PULL_INT8, and the EXCHANGE fused pull half)
  void record_pull_locked() {
    auto it = pull_versions.find(conn_wid_);
    if (it != pull_versions.end()) prev_pull_versions[conn_wid_] = it->second;
    pull_versions[conn_wid_] = num_updates;
  }

  // fold scale for one commit from conn_wid_'s staleness — call under mu
  float fold_scale_locked() { return scale_from_pv_locked(priced_pv_locked(false)); }

  void handle(int fd) {
    std::vector<float> buf(n);
    // int8-commit scratch, sized lazily on first use and reused across
    // commits (the wire hot path must not heap-allocate per message)
    std::vector<int8_t> qbuf;
    std::vector<uint64_t> lens;
    std::vector<float> scales;
    std::vector<float> pscales;  // compressed-pull per-block scales
    std::vector<float> wbuf;     // durable int8 commits: dequantized
                                 // payload staged off-lock for the WAL
    std::vector<float> obuf;     // EXCHANGE reply scratch: the commit
                                 // payload in `buf` stays pinned for the
                                 // zero-copy WAL wait, so the fused pull
                                 // snapshot needs its own buffer
    for (;;) {
      uint8_t action;
      if (!recv_all(fd, &action, 1)) break;
      // every action that records a pull or folds a commit renews the
      // worker's lease first: PULL, COMMIT, COMMIT_INT8, PULL_INT8,
      // COMMIT_SEQ, COMMIT_SEQ_E, EXCHANGE
      switch (action) {
        case 1: case 2: case 4: case 5: case 7: case 10: case 14:
          touch(conn_wid_);
          break;
        default:
          break;
      }
      if (action == 1) {  // PULL
        uint64_t version;
        {
          // copy under the lock, send outside it: a slow client must not
          // serialize every other worker's fold behind its TCP window
          StatGuard g(this);
          version = num_updates;
          // staleness bookkeeping, exactly the Python PS's pull():
          // tau at the next commit = center updates since this pull
          record_pull_locked();
          if (wal_on) wal_append_pull_locked(conn_wid_, num_updates);
          std::memcpy(buf.data(), center.data(), n * sizeof(float));
        }
        {
          PendingGuard pg(this);  // reply-send → counter settling window
          if (!send_all(fd, &version, 8)) break;
          if (!send_all(fd, buf.data(), n * sizeof(float))) break;
          st_pulls += 1;
          st_bytes_out += n * sizeof(float);
        }
      } else if (action == 5) {  // PULL_INT8: block-quantized center + EF
        const uint64_t nb = pull_blocks(n);
        if (qbuf.size() != n) qbuf.resize(n);
        if (pscales.size() != nb) pscales.resize(nb);
        // Only the center SNAPSHOT needs the center mutex; quantization
        // holds the WORKER's own mutex instead, so different workers'
        // pulls overlap while a same-wid reconnect (old handler still
        // mid-quantize) serializes instead of racing on the residual.
        uint64_t version;
        PullErr* pe;
        {
          StatGuard g(this);
          version = num_updates;
          record_pull_locked();                    // same staleness
          if (wal_on) wal_append_pull_locked(conn_wid_, num_updates);
          pe = &pull_errors[conn_wid_];            // bookkeeping as PULL
          std::memcpy(buf.data(), center.data(), n * sizeof(float));
        }
        std::lock_guard<std::mutex> wg(pe->m);
        encode_int8_blocks(buf.data(), pe->err, qbuf, pscales);
        uint32_t nb32 = static_cast<uint32_t>(nb);
        {
          PendingGuard pg(this);  // settling window, see PULL
          if (!send_all(fd, &version, 8) || !send_all(fd, &nb32, 4) ||
              !send_all(fd, pscales.data(), nb * sizeof(float)) ||
              !send_all(fd, qbuf.data(), n)) {
            // dropped reply: the client never received this blob — roll
            // the residual back to its pre-pull state (still under wg)
            rollback_int8_blocks(buf.data(), pe->err, qbuf, pscales);
            break;
          }
          st_cpulls += 1;
          st_bytes_out += nb * sizeof(float) + n;
        }
      } else if (action == 2) {  // COMMIT
        if (!recv_all(fd, buf.data(), n * sizeof(float))) break;
        uint8_t ack = 1;
        // the O(model) payload hash runs OFF the center mutex, in this
        // worker's handler thread — the lock's section stays fold+append
        const uint32_t pcrc =
            wal_on ? adler32_buf(buf.data(), n * sizeof(float)) : 0;
        std::vector<char> staged;  // window 0: payload copy, OFF the mutex
        if (wal_on && wal.window == 0) {
          const char* pb = reinterpret_cast<const char*>(buf.data());
          staged.assign(pb, pb + n * sizeof(float));
        }
        uint64_t tok = 0;
        {
          StatGuard g(this);
          const float s = fold_scale_locked();
          float* c = center.data();
          const float* d = buf.data();
          for (uint64_t i = 0; i < n; ++i) c[i] += d[i] * s;
          ema_fold_locked();
          num_updates += 1;
          if (wal_on)
            tok = wal_append_commit_locked(
                conn_wid_, -1, pull_version_locked(), num_updates, s,
                d, n, pcrc, wal.window == 0 ? &staged : nullptr);
        }
        st_commits += 1;
        st_bytes_in += n * sizeof(float);
        if (tok && wal.window >= 1 && !wal_wait(tok)) break;  // crashed
        if (!send_all(fd, &ack, 1)) break;
      } else if (action == 4) {  // COMMIT_INT8: per-segment scaled int8
        uint32_t segs;
        if (!recv_all(fd, &segs, 4)) break;
        // segment count and lengths are validated against the pinned n
        // BEFORE any allocation beyond n bytes — a hostile header cannot
        // oversize the payload or overflow the fold loop's bounds
        if (segs == 0 || segs > (1u << 20) || segs > n) break;
        lens.resize(segs);
        scales.resize(segs);
        uint64_t total = 0;
        bool bad = false;
        for (uint32_t i = 0; i < segs; ++i) {
          if (!recv_all(fd, &lens[i], 8) || !recv_all(fd, &scales[i], 4)) {
            bad = true;
            break;
          }
          if (lens[i] > n || total + lens[i] > n) {  // no u64 wrap possible
            bad = true;
            break;
          }
          total += lens[i];
        }
        if (bad || total != n) break;
        if (qbuf.size() != n) qbuf.resize(n);
        if (!recv_all(fd, qbuf.data(), n)) break;
        uint8_t ack = 1;
        uint32_t pcrc = 0;
        if (wal_on) {
          // durable int8 commits dequantize OFF the mutex into wbuf and
          // fold `c += s * wbuf` — two rounding steps instead of the
          // no-WAL path's fused `(s*scale_seg)*q`, because the REPLAY
          // must reproduce the fold from the logged dense payload with
          // one multiply; logging q+scales would save bytes but force
          // the replayer to re-implement this segment walk
          if (wbuf.size() != n) wbuf.resize(n);
          uint64_t off = 0;
          for (uint32_t seg = 0; seg < segs; ++seg) {
            const float sc = scales[seg];
            const int8_t* d = qbuf.data() + off;
            for (uint64_t i = 0; i < lens[seg]; ++i)
              wbuf[off + i] = sc * static_cast<float>(d[i]);
            off += lens[seg];
          }
          pcrc = adler32_buf(wbuf.data(), n * sizeof(float));
        }
        std::vector<char> staged;  // window 0: payload copy, OFF the mutex
        if (wal_on && wal.window == 0) {
          const char* pb = reinterpret_cast<const char*>(wbuf.data());
          staged.assign(pb, pb + n * sizeof(float));
        }
        uint64_t tok = 0;
        {
          StatGuard g(this);
          const float s = fold_scale_locked();
          float* c = center.data();
          if (wal_on) {
            const float* d = wbuf.data();
            for (uint64_t i = 0; i < n; ++i) c[i] += d[i] * s;
          } else {
            uint64_t off = 0;
            for (uint32_t seg = 0; seg < segs; ++seg) {
              const float ss = s * scales[seg];
              const int8_t* d = qbuf.data() + off;
              for (uint64_t i = 0; i < lens[seg]; ++i)
                c[off + i] += ss * static_cast<float>(d[i]);
              off += lens[seg];
            }
          }
          ema_fold_locked();
          num_updates += 1;
          if (wal_on)
            tok = wal_append_commit_locked(
                conn_wid_, -1, pull_version_locked(), num_updates, s,
                wbuf.data(), n, pcrc,
                wal.window == 0 ? &staged : nullptr);
        }
        st_commits += 1;
        st_bytes_in += static_cast<uint64_t>(segs) * 12 + n;
        if (tok && wal.window >= 1 && !wal_wait(tok)) break;
        if (!send_all(fd, &ack, 1)) break;
      } else if (action == 7) {  // COMMIT_SEQ: retry-safe seq'd commit
        uint64_t seq;
        if (!recv_all(fd, &seq, 8)) break;
        if (!recv_all(fd, buf.data(), n * sizeof(float))) break;
        const uint32_t pcrc =
            wal_on ? adler32_buf(buf.data(), n * sizeof(float)) : 0;
        std::vector<char> staged;  // window 0: payload copy, OFF the mutex
        if (wal_on && wal.window == 0) {
          const char* pb = reinterpret_cast<const char*>(buf.data());
          staged.assign(pb, pb + n * sizeof(float));
        }
        bool dup;
        uint64_t tok = 0;
        {
          StatGuard g(this);
          uint64_t& last = last_seq[conn_wid_];
          dup = seq <= last;
          if (!dup) {
            last = seq;
            const float s = fold_scale_locked();
            float* c = center.data();
            const float* d = buf.data();
            for (uint64_t i = 0; i < n; ++i) c[i] += d[i] * s;
            ema_fold_locked();
            num_updates += 1;
            if (wal_on)
              tok = wal_append_commit_locked(
                  conn_wid_, static_cast<int64_t>(seq),
                  pull_version_locked(), num_updates, s, d, n, pcrc,
                  wal.window == 0 ? &staged : nullptr);
          }
        }
        if (dup) {
          st_dups += 1;
        } else {
          st_commits += 1;
        }
        st_bytes_in += n * sizeof(float);
        if (tok && wal.window >= 1 && !wal_wait(tok)) break;
        uint8_t ack = dup ? 2 : 1;
        if (!send_all(fd, &ack, 1)) break;
      } else if (action == 10) {  // COMMIT_SEQ_E: fenced + seq'd commit
        uint64_t epoch, seq;
        if (!recv_all(fd, &epoch, 8)) break;
        if (!recv_all(fd, &seq, 8)) break;
        if (!recv_all(fd, buf.data(), n * sizeof(float))) break;
        const uint32_t pcrc =
            wal_on ? adler32_buf(buf.data(), n * sizeof(float)) : 0;
        std::vector<char> staged;  // window 0: payload copy, OFF the mutex
        if (wal_on && wal.window == 0) {
          const char* pb = reinterpret_cast<const char*>(buf.data());
          staged.assign(pb, pb + n * sizeof(float));
        }
        bool dup = false, fenced = false;
        uint64_t server_epoch;
        uint64_t tok = 0;
        const uint64_t t_fold = trace_t0();  // fold span
        {
          StatGuard g(this);
          server_epoch = fence_epoch;
          fenced = epoch != fence_epoch;
          if (!fenced) {
            uint64_t& last = last_seq[conn_wid_];
            dup = seq <= last;
            if (!dup) {
              last = seq;
              const float s = fold_scale_locked();
              float* c = center.data();
              const float* d = buf.data();
              for (uint64_t i = 0; i < n; ++i) c[i] += d[i] * s;
              ema_fold_locked();
              num_updates += 1;
              if (wal_on)
                tok = wal_append_commit_locked(
                    conn_wid_, static_cast<int64_t>(seq),
                    pull_version_locked(), num_updates, s, d, n, pcrc,
                    wal.window == 0 ? &staged : nullptr);
            }
          }
        }
        trace_rec(TK_FOLD, conn_wid_, seq, t_fold);
        if (fenced) {
          st_fenced += 1;
        } else if (dup) {
          st_dups += 1;
        } else {
          st_commits += 1;
        }
        st_bytes_in += n * sizeof(float);
        if (tok && wal.window >= 1) {
          const uint64_t t_w = trace_t0();
          const bool durable = wal_wait(tok);
          trace_rec(TK_WAL_WAIT, conn_wid_, seq, t_w);
          if (!durable) break;
        }
        uint8_t ack = fenced ? 3 : (dup ? 2 : 1);
        if (!send_all(fd, &ack, 1)) break;
        if (!send_all(fd, &server_epoch, 8)) break;
      } else if (action == 9) {  // FENCE: raise the fencing epoch
        uint64_t epoch;
        if (!recv_all(fd, &epoch, 8)) break;
        uint64_t now_epoch;
        uint64_t tok = 0;
        {
          StatGuard g(this);
          if (epoch > fence_epoch) fence_epoch = epoch;
          now_epoch = fence_epoch;
          if (wal_on) tok = wal_append_fence_locked(now_epoch);
        }
        // the fence ack implies durability (parity with the Python PS)
        if (tok && !wal_wait(tok)) break;
        uint8_t ack = 1;
        if (!send_all(fd, &ack, 1)) break;
        if (!send_all(fd, &now_epoch, 8)) break;
      } else if (action == 6) {  // HEARTBEAT: lease renewal
        uint32_t retries;
        if (!recv_all(fd, &retries, 4)) break;
        const bool known = heartbeat(conn_wid_, retries);
        uint8_t ack = known ? 1 : 2;
        if (!send_all(fd, &ack, 1)) break;
      } else if (action == 8) {  // DEREGISTER: clean exit, no eviction
        deregister(conn_wid_);
        uint8_t ack = 1;
        if (!send_all(fd, &ack, 1)) break;
      } else if (action == 12) {  // JOIN: elastic live-join admission
        // reply: u8 ack + u64 num_updates + u64 pool_size (parity with
        // the Python "join" action's {pool_size, num_updates} record)
        const int64_t pool = join_wid(conn_wid_);
        uint64_t updates;
        {
          std::lock_guard<std::mutex> g(mu);
          updates = num_updates;
        }
        uint8_t ack = 1;
        uint64_t pool_u = pool < 0 ? 0 : static_cast<uint64_t>(pool);
        if (!send_all(fd, &ack, 1)) break;
        if (!send_all(fd, &updates, 8)) break;
        if (!send_all(fd, &pool_u, 8)) break;
      } else if (action == 13) {  // DRAIN: preemption drain
        uint8_t timed_out;
        if (!recv_all(fd, &timed_out, 1)) break;
        drain_wid(conn_wid_, timed_out != 0);
        uint8_t ack = 1;
        if (!send_all(fd, &ack, 1)) break;
      } else if (action == 14) {  // EXCHANGE: fused commit + pull
        // One round trip folds the commit and answers with the fresh
        // post-fold center — the wire fusion of COMMIT_SEQ_E
        // + PULL(_INT8). flags: bit0 seq, bit1 epoch, bit2 int8 reply,
        // bit3 lag (price tau from the PREVIOUS pull version — the
        // pipelined worker's delta is one exchange stale). A duplicate
        // seq skips the fold but still gets the pull half; a fenced
        // exchange gets neither.
        uint8_t flags;
        if (!recv_all(fd, &flags, 1)) break;
        const bool has_seq = flags & 1, has_epoch = flags & 2;
        const bool want_int8 = flags & 4, lag = flags & 8;
        uint64_t epoch = 0, seq = 0;
        if (has_epoch && !recv_all(fd, &epoch, 8)) break;
        if (has_seq && !recv_all(fd, &seq, 8)) break;
        if (!recv_all(fd, buf.data(), n * sizeof(float))) break;
        const uint32_t pcrc =
            wal_on ? adler32_buf(buf.data(), n * sizeof(float)) : 0;
        std::vector<char> staged;  // window 0: payload copy, OFF the mutex
        if (wal_on && wal.window == 0) {
          const char* pb = reinterpret_cast<const char*>(buf.data());
          staged.assign(pb, pb + n * sizeof(float));
        }
        if (obuf.size() != n) obuf.resize(n);
        const uint64_t nb = pull_blocks(n);
        if (want_int8) {
          if (qbuf.size() != n) qbuf.resize(n);
          if (pscales.size() != nb) pscales.resize(nb);
        }
        bool dup = false, fenced = false;
        uint64_t server_epoch, version = 0, tok = 0;
        PullErr* pe = nullptr;
        const uint64_t t_fold = trace_t0();  // fold span
        {
          StatGuard g(this);
          server_epoch = fence_epoch;
          fenced = has_epoch && epoch != fence_epoch;
          if (!fenced) {
            if (has_seq) {
              uint64_t& last = last_seq[conn_wid_];
              dup = seq <= last;
              if (!dup) last = seq;
            }
            if (!dup) {
              const uint64_t pv = priced_pv_locked(lag);
              const float s = scale_from_pv_locked(pv);
              float* c = center.data();
              const float* d = buf.data();
              for (uint64_t i = 0; i < n; ++i) c[i] += d[i] * s;
              ema_fold_locked();
              num_updates += 1;
              if (wal_on)
                tok = wal_append_commit_locked(
                    conn_wid_, has_seq ? static_cast<int64_t>(seq) : -1,
                    pv, num_updates, s, d, n, pcrc,
                    wal.window == 0 ? &staged : nullptr);
            }
            // fused pull half — applied AND duplicate commits get it (a
            // lost-ACK replay still needs a fresh center, and recording
            // its version is exactly what a retried pull would do)
            record_pull_locked();
            version = num_updates;
            if (wal_on) wal_append_pull_locked(conn_wid_, num_updates);
            if (want_int8) pe = &pull_errors[conn_wid_];
            std::memcpy(obuf.data(), center.data(), n * sizeof(float));
          }
        }
        trace_rec(TK_FOLD, conn_wid_, has_seq ? seq : 0, t_fold);
        if (fenced) {
          st_fenced += 1;
        } else if (dup) {
          st_dups += 1;
        } else {
          st_commits += 1;
        }
        st_bytes_in += n * sizeof(float);
        if (tok && wal.window >= 1) {
          const uint64_t t_w = trace_t0();  // deferred-ACK wait span
          const bool durable = wal_wait(tok);
          trace_rec(TK_WAL_WAIT, conn_wid_, has_seq ? seq : 0, t_w);
          if (!durable) break;  // crashed
        }
        uint8_t ack = fenced ? 3 : (dup ? 2 : 1);
        {
          PendingGuard pg(this);  // settling window, see PULL
          if (!send_all(fd, &ack, 1)) break;
          if (!send_all(fd, &server_epoch, 8)) break;
          if (fenced) continue;
          if (!send_all(fd, &version, 8)) break;
          if (!want_int8) {
            if (!send_all(fd, obuf.data(), n * sizeof(float))) break;
            st_pulls += 1;
            st_bytes_out += n * sizeof(float);
            st_fused += 1;
          } else {
            // block-quantize obuf + this worker's EF residual — the SAME
            // encode/rollback helpers as PULL_INT8, so the fused and
            // standalone compressed-pull wires cannot drift
            std::lock_guard<std::mutex> wg(pe->m);
            encode_int8_blocks(obuf.data(), pe->err, qbuf, pscales);
            uint32_t nb32 = static_cast<uint32_t>(nb);
            if (!send_all(fd, &nb32, 4) ||
                !send_all(fd, pscales.data(), nb * sizeof(float)) ||
                !send_all(fd, qbuf.data(), n)) {
              rollback_int8_blocks(obuf.data(), pe->err, qbuf, pscales);
              break;
            }
            st_cpulls += 1;
            st_bytes_out += nb * sizeof(float) + n;
            st_fused += 1;
          }
        }
      } else if (action == 15) {  // TRACE: drain the span ring
        // reply: u64 count, then count * 5 u64 records of
        // (kind, wid, seq, t0_ns, dur_ns). DRAINING read: a scrape
        // empties the ring, so repeated scrapes never duplicate spans.
        std::vector<std::array<uint64_t, 5>> recs;
        {
          std::lock_guard<std::mutex> g(trace_mu);
          const uint64_t have =
              trace_head < kTraceCap ? trace_head : kTraceCap;
          recs.reserve(have);
          for (uint64_t k = trace_head - have; k < trace_head; ++k)
            recs.push_back(trace_ring[k % kTraceCap]);
          trace_ring.clear();
          trace_head = 0;
        }
        uint64_t cnt = recs.size();
        if (!send_all(fd, &cnt, 8)) break;
        if (cnt &&
            !send_all(fd, recs.data(),
                      cnt * sizeof(std::array<uint64_t, 5>)))
          break;
      } else if (action == 11) {  // SHARD_INFO: shard-map handshake
        // reply: u32 shard_id, u32 num_shards (0 = unsharded), u64
        // fence_epoch — the sharded client verifies it is wired to the
        // shard it represents before folding anything (parity with the
        // Python server's "shard_map" action)
        uint32_t info[2] = {shard_id.load(), num_shards.load()};
        uint64_t epoch;
        {
          std::lock_guard<std::mutex> g(mu);
          epoch = fence_epoch;
        }
        if (!send_all(fd, info, 8)) break;
        if (!send_all(fd, &epoch, 8)) break;
      } else {  // BYE or garbage: drop the connection either way
        break;
      }
    }
    {
      // prune BEFORE closing: stop() must never shutdown() a descriptor
      // number the kernel has already reused for something else
      std::lock_guard<std::mutex> g(conn_mu);
      conn_fds.erase(std::remove(conn_fds.begin(), conn_fds.end(), fd),
                     conn_fds.end());
    }
    close_conn_fd(fd);
  }

  // per-handler worker id — set via the thread entry, see serve_conn
  static thread_local uint32_t conn_wid_;

  void serve_conn(int fd, uint32_t wid) {
    conn_wid_ = wid;
    handle(fd);
  }

  void record_pull_version(uint32_t wid) {
    std::lock_guard<std::mutex> g(mu);
    auto it = pull_versions.find(wid);
    if (it != pull_versions.end()) prev_pull_versions[wid] = it->second;
    pull_versions[wid] = num_updates;
  }
};

thread_local uint32_t Server::conn_wid_ = 0;

struct Client {
  int fd = -1;
  uint64_t n = 0;
  uint32_t wid = 0;
};

int connect_to(const char* host, int port) {
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return -1;
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (::inet_pton(AF_INET, host, &addr.sin_addr) != 1) {
    ::close(fd);
    return -1;
  }
  if (::connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0) {
    ::close(fd);
    return -1;
  }
  set_nodelay(fd);
  return fd;
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------- server --

void* dkps_server_create(const float* init, uint64_t n, int mode,
                         double fixed_scale, const char* host, int port,
                         double ema_decay, double lease_timeout) {
  auto* s = new Server();
  s->center.assign(init, init + n);
  s->n = n;
  s->mode = mode;
  s->fixed_scale = fixed_scale;
  s->ema_decay = ema_decay;
  if (ema_decay >= 0) s->ema = s->center;
  // lease_timeout <= 0 keeps the 30 s default (leases only matter once a
  // client heartbeats — a heartbeat-free run never evicts anything)
  if (lease_timeout > 0) s->lease_timeout_s = lease_timeout;

  s->listen_fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (s->listen_fd < 0) {
    delete s;
    return nullptr;
  }
  int one = 1;
  ::setsockopt(s->listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (::inet_pton(AF_INET, host, &addr.sin_addr) != 1 ||
      ::bind(s->listen_fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) !=
          0 ||
      ::listen(s->listen_fd, 64) != 0) {
    ::close(s->listen_fd);
    delete s;
    return nullptr;
  }
  sockaddr_in bound{};
  socklen_t blen = sizeof(bound);
  ::getsockname(s->listen_fd, reinterpret_cast<sockaddr*>(&bound), &blen);
  s->port = ntohs(bound.sin_port);
  return s;
}

int dkps_server_port(void* h) { return static_cast<Server*>(h)->port; }

int dkps_server_start(void* h) {
  auto* s = static_cast<Server*>(h);
  s->running = true;
  s->accept_thread = std::thread([s] {
    while (s->running) {
      int fd = ::accept(s->listen_fd, nullptr, nullptr);
      if (fd < 0) {
        if (s->running && (errno == EINTR || errno == ECONNABORTED)) continue;
        break;
      }
      if (!s->running) {
        ::close(fd);
        break;
      }
      set_nodelay(fd);
      // handshake: magic + worker_id + n; reject on any mismatch
      char magic[6];
      uint32_t wid;
      uint64_t cn;
      if (!recv_all(fd, magic, 6) || std::memcmp(magic, kMagic, 6) != 0 ||
          !recv_all(fd, &wid, 4) || !recv_all(fd, &cn, 8)) {
        ::close(fd);
        continue;
      }
      uint8_t ok = (cn == s->n) ? 1 : 0;
      if (!send_all(fd, &ok, 1) || !ok) {
        ::close(fd);
        continue;
      }
      std::lock_guard<std::mutex> g(s->conn_mu);
      s->conn_fds.push_back(fd);
      s->handlers.emplace_back([s, fd, wid] { s->serve_conn(fd, wid); });
    }
  });
  return 0;
}

// Attach one shared-memory ring connection (the shm lane,
// parity with shm.py): `base` is the caller-mapped segment
// (4 KiB header + two SPSC rings; the Python wrapper creates, owns, and
// unlinks it). Spawns a handler thread running the SAME handshake +
// action loop an accepted TCP connection gets, dispatched over the rings
// via the negative pseudo-fd. Returns that pseudo-fd (< 0) or 0 on
// failure. Call after dkps_server_start and BEFORE the peer's
// dkps_client_connect_shm — the client handshake blocks on the ring
// until this handler answers it.
int dkps_server_attach_shm(void* h, void* base, uint64_t bytes) {
  auto* s = static_cast<Server*>(h);
  if (!s->running) return 0;
  const int fd = shm_register(base, bytes, /*server_side=*/true);
  if (fd == 0) return 0;
  std::lock_guard<std::mutex> g(s->conn_mu);
  if (!s->running) {
    // stop() raced the attach: its conn_mu shutdown section has (or
    // will have) run, and its handler-join loop iterates WITHOUT the
    // lock — appending now would race that iteration and leave an
    // unjoined thread outliving the server. Re-checking under conn_mu
    // closes the window: stop() flips running before ITS conn_mu
    // section, so an attach that sees running here is fully registered
    // before stop's shutdown loop (which then closes the new channel).
    close_conn_fd(fd);
    return 0;
  }
  s->conn_fds.push_back(fd);
  s->handlers.emplace_back([s, fd] {
    // the accept loop's handshake, over the ring: magic + worker_id +
    // vector length, answered with the accept byte
    char magic[6];
    uint32_t wid;
    uint64_t cn;
    uint8_t ok = 0;
    if (recv_all(fd, magic, 6) && std::memcmp(magic, kMagic, 6) == 0 &&
        recv_all(fd, &wid, 4) && recv_all(fd, &cn, 8)) {
      ok = (cn == s->n) ? 1 : 0;
      if (send_all(fd, &ok, 1) && ok) {
        s->serve_conn(fd, wid);  // prunes conn_fds + closes at its tail
        return;
      }
    }
    {
      std::lock_guard<std::mutex> g2(s->conn_mu);
      s->conn_fds.erase(
          std::remove(s->conn_fds.begin(), s->conn_fds.end(), fd),
          s->conn_fds.end());
    }
    close_conn_fd(fd);
  });
  return fd;
}

void dkps_server_stop(void* h) {
  auto* s = static_cast<Server*>(h);
  if (!s->running.exchange(false)) {
    s->wal_close();  // idempotent; a crash() already abandoned it
    return;
  }
  ::shutdown(s->listen_fd, SHUT_RDWR);
  ::close(s->listen_fd);
  if (s->accept_thread.joinable()) s->accept_thread.join();
  {
    std::lock_guard<std::mutex> g(s->conn_mu);
    for (int fd : s->conn_fds) shutdown_conn_fd(fd);
  }
  for (auto& t : s->handlers)
    if (t.joinable()) t.join();
  s->wal_close();  // clean stop: drain + fsync + close the log
}

// Crash seam (parity with SocketParameterServer._crash): die like a
// SIGKILL'd process — tear the listener and every live connection, and
// abandon the WAL losing its user-space pending buffer WITHOUT a flush
// or fsync. Records an earlier group fsync made durable survive; the
// torn group's commits were never ACKed, so their clients replay them
// against the recovered server and the dedup table folds each once.
void dkps_server_crash(void* h) {
  auto* s = static_cast<Server*>(h);
  if (s->running.exchange(false)) {
    ::shutdown(s->listen_fd, SHUT_RDWR);
    ::close(s->listen_fd);
    std::lock_guard<std::mutex> g(s->conn_mu);
    for (int fd : s->conn_fds) shutdown_conn_fd(fd);
  }
  s->wal_abandon();
  if (s->accept_thread.joinable()) s->accept_thread.join();
  for (auto& t : s->handlers)
    if (t.joinable()) t.join();
}

// Attach the write-ahead log: open `path` for appending and start the
// group-commit flusher (`window` commits per fsync batch, 0 = async
// time-bounded mode; `interval_s` bounds the durability window in
// seconds either way). Call BEFORE dkps_server_start. Returns 0, or -1
// when the file cannot be opened. The Python wrapper owns recovery,
// snapshot publication, and torn-tail truncation — this side only
// appends records to the live segment it is handed.
int dkps_server_wal_open(void* h, const char* path, uint64_t window,
                         double interval_s) {
  auto* s = static_cast<Server*>(h);
  int fd = ::open(path, O_WRONLY | O_APPEND | O_CREAT | O_CLOEXEC, 0644);
  if (fd < 0) return -1;
  s->wal.fd = fd;
  s->wal.window = window;
  s->wal.interval_s = interval_s > 0 ? interval_s : 0.25;
  s->wal.running = true;
  s->wal_on = true;
  s->wal.flusher = std::thread([s] { s->wal_flush_loop(); });
  return 0;
}

void dkps_server_destroy(void* h) {
  auto* s = static_cast<Server*>(h);
  dkps_server_stop(s);
  delete s;
}

uint64_t dkps_server_num_updates(void* h) {
  auto* s = static_cast<Server*>(h);
  std::lock_guard<std::mutex> g(s->mu);
  return s->num_updates;
}

void dkps_server_set_num_updates(void* h, uint64_t v) {
  auto* s = static_cast<Server*>(h);
  std::lock_guard<std::mutex> g(s->mu);
  s->num_updates = v;
}

void dkps_server_get_center(void* h, float* out) {
  auto* s = static_cast<Server*>(h);
  std::lock_guard<std::mutex> g(s->mu);
  std::memcpy(out, s->center.data(), s->n * sizeof(float));
}

void dkps_server_set_center(void* h, const float* in) {
  auto* s = static_cast<Server*>(h);
  std::lock_guard<std::mutex> g(s->mu);
  std::memcpy(s->center.data(), in, s->n * sizeof(float));
  // a restored center restarts the average from itself (EMA state is not
  // checkpointed — same policy as the Python trainers)
  if (s->ema_decay >= 0) s->ema = s->center;
}

// EMA read: 0 on success, -1 when the server was created without EMA
int dkps_server_get_ema(void* h, float* out) {
  auto* s = static_cast<Server*>(h);
  std::lock_guard<std::mutex> g(s->mu);
  if (s->ema_decay < 0) return -1;
  std::memcpy(out, s->ema.data(), s->n * sizeof(float));
  return 0;
}

// record a pull version server-side (used by the in-process owner when it
// folds without the wire; wire pulls record via the PULL action below)
void dkps_server_record_pull(void* h, uint32_t wid) {
  static_cast<Server*>(h)->record_pull_version(wid);
}

// Contention/throughput counters (parity with the Python PS's stats()).
// Fills out[22]: pulls, compressed_pulls, commits, bytes_in, bytes_out,
// center_lock_acquires, center_lock_wait_ns, center_lock_hold_ns,
// dup_commits, active_workers, evicted_workers, heartbeats,
// worker_retries, fenced_commits, wal_records, wal_fsyncs,
// wal_group_max, pool_size, joined_workers, preempted_workers,
// drain_timeouts, fused_exchanges. Runs a FORCED expiry pass first (a stats read must see
// already-lapsed leases as evicted — no rate-limit window); the counter
// reads stay lock-free atomics and may lag in-flight ops by one —
// telemetry semantics, same as the Python side.
void dkps_server_stats(void* h, uint64_t* out) {
  auto* s = static_cast<Server*>(h);
  s->expire_leases(/*force=*/true);
  // settling barrier: pull-side counters land after the
  // reply send — wait (bounded) for in-flight reply windows to close so
  // an end-of-run read is exact; under continuous traffic the gauge
  // passes through zero between ops, and a wedged sender degrades to
  // the historical may-lag semantics after the deadline
  const auto deadline =
      std::chrono::steady_clock::now() + std::chrono::seconds(1);
  while (s->st_pending.load() != 0 &&
         std::chrono::steady_clock::now() < deadline)
    std::this_thread::sleep_for(std::chrono::milliseconds(1));
  out[0] = s->st_pulls.load();
  out[1] = s->st_cpulls.load();
  out[2] = s->st_commits.load();
  out[3] = s->st_bytes_in.load();
  out[4] = s->st_bytes_out.load();
  out[5] = s->st_lock_acquires.load();
  out[6] = s->st_lock_wait_ns.load();
  out[7] = s->st_lock_hold_ns.load();
  out[8] = s->st_dups.load();
  {
    std::lock_guard<std::mutex> g(s->lease_mu);
    uint64_t retries = 0;
    for (const auto& kv : s->retries_by_wid) retries += kv.second;
    out[9] = s->leases.size();
    out[10] = s->st_evicted.load();
    out[11] = s->st_heartbeats.load();
    out[12] = retries;
  }
  out[13] = s->st_fenced.load();
  out[14] = s->wal.st_records.load();
  out[15] = s->wal.st_fsyncs.load();
  out[16] = s->wal.st_group_max.load();
  const int64_t pool = s->st_pool.load();
  out[17] = pool < 0 ? 0 : static_cast<uint64_t>(pool);
  out[18] = s->st_joined.load();
  out[19] = s->st_preempted.load();
  out[20] = s->st_drain_to.load();
  out[21] = s->st_fused.load();
}

// Elastic pool gauge base (resilience/elastic.py): the wrapper sets the
// configured worker count at initialize() — the C ABI has no num_workers
// of its own (the fold scale is baked into the mode) — and JOIN/DRAIN
// adjust it from there.
void dkps_server_set_pool_size(void* h, int64_t n) {
  static_cast<Server*>(h)->st_pool.store(n);
}

// Flight recorder: arm/disarm the server's span ring. Spans
// cover the EXCHANGE/COMMIT_SEQ_E fold sections, the deferred-ACK WAL
// wait, and the flusher's group fsync; drain them with the TRACE wire
// action (dkps_client_trace_scrape).
void dkps_server_set_trace(void* h, int on) {
  static_cast<Server*>(h)->trace_on.store(on != 0);
}

// -- durable-state restore (crash recovery; the Python wrapper replays
// the log with resilience/wal.py and installs the result here) ----------

// EMA restore: 0 on success, -1 when the server was created without EMA.
// Must run after dkps_server_set_center (which resets the EMA to the
// center) and before serving traffic.
int dkps_server_set_ema(void* h, const float* in) {
  auto* s = static_cast<Server*>(h);
  std::lock_guard<std::mutex> g(s->mu);
  if (s->ema_decay < 0) return -1;
  std::memcpy(s->ema.data(), in, s->n * sizeof(float));
  return 0;
}

// Per-worker recovered state: last applied commit seqno (-1 = none),
// recorded pull version (-1 = none), and the PREVIOUS pull version
// (-1 = none; the pipelined exchange's lag-pricing base) — the dedup
// fence and the DynSGD staleness bases must survive a restart, or a
// replayed pre-crash commit double-folds / gets mispriced.
void dkps_server_restore_worker(void* h, uint32_t wid, int64_t last_seq,
                                int64_t pull_version,
                                int64_t prev_pull_version) {
  auto* s = static_cast<Server*>(h);
  std::lock_guard<std::mutex> g(s->mu);
  if (last_seq >= 0) s->last_seq[wid] = static_cast<uint64_t>(last_seq);
  if (pull_version >= 0)
    s->pull_versions[wid] = static_cast<uint64_t>(pull_version);
  if (prev_pull_version >= 0)
    s->prev_pull_versions[wid] = static_cast<uint64_t>(prev_pull_version);
}

// fencing-epoch admin (parity with ParameterServer.fence / fence_epoch);
// durable before returning when a WAL is attached, like the Python PS
uint64_t dkps_server_fence(void* h, uint64_t epoch) {
  auto* s = static_cast<Server*>(h);
  uint64_t out, tok = 0;
  {
    std::lock_guard<std::mutex> g(s->mu);
    if (epoch > s->fence_epoch) s->fence_epoch = epoch;
    out = s->fence_epoch;
    if (s->wal_on && s->wal.running) tok = s->wal_append_fence_locked(out);
  }
  if (tok) s->wal_wait(tok);
  return out;
}

uint64_t dkps_server_fence_epoch(void* h) {
  auto* s = static_cast<Server*>(h);
  std::lock_guard<std::mutex> g(s->mu);
  return s->fence_epoch;
}

// Shard-map record (the sharding layer): this server holds shard
// `sid` of an `n_shards`-way partitioned center. Served to clients via
// SHARD_INFO (action 11); n_shards 0 = unsharded (the default).
void dkps_server_set_shard(void* h, uint32_t sid, uint32_t n_shards) {
  auto* s = static_cast<Server*>(h);
  s->shard_id.store(sid);
  s->num_shards.store(n_shards);
}

// ---------------------------------------------------------------- client --

static void* client_handshake(int fd, uint32_t wid, uint64_t n) {
  char hello[6 + 4 + 8];
  std::memcpy(hello, kMagic, 6);
  std::memcpy(hello + 6, &wid, 4);
  std::memcpy(hello + 10, &n, 8);
  uint8_t ok = 0;
  if (!send_all(fd, hello, sizeof(hello)) || !recv_all(fd, &ok, 1) || !ok) {
    close_conn_fd(fd);
    return nullptr;
  }
  auto* c = new Client();
  c->fd = fd;
  c->n = n;
  c->wid = wid;
  return c;
}

void* dkps_client_connect(const char* host, int port, uint32_t wid,
                          uint64_t n) {
  int fd = connect_to(host, port);
  if (fd < 0) return nullptr;
  return client_handshake(fd, wid, n);
}

// Adopt an already-connected (blocking-mode) socket — DNS resolution,
// IPv6, and connect timeouts stay the caller's (Python's) problem; the
// hot-path framing stays native. Closes fd on handshake failure.
void* dkps_client_from_fd(int fd, uint32_t wid, uint64_t n) {
  set_nodelay(fd);
  return client_handshake(fd, wid, n);
}

// Connect over a shared-memory ring pair: `base` is the same
// mapped segment the server side attached with dkps_server_attach_shm.
// Runs the standard handshake through the ring; the returned handle
// speaks every client op unchanged (the pseudo-fd dispatches in
// send_all/recv_all).
void* dkps_client_connect_shm(void* base, uint64_t bytes, uint32_t wid,
                              uint64_t n) {
  const int fd = shm_register(base, bytes, /*server_side=*/false);
  if (fd == 0) return nullptr;
  return client_handshake(fd, wid, n);
}

// Bound every subsequent pull/commit round-trip: a wedged server makes the
// call fail with a transport error instead of hanging the caller forever.
int dkps_client_set_timeout_ms(void* h, int ms) {
  auto* c = static_cast<Client*>(h);
  if (c->fd < 0) {  // ring lane: the channel carries its own deadline
    shm_chan(c->fd)->timeout_ms.store(ms, std::memory_order_relaxed);
    return 0;
  }
  timeval tv{};
  tv.tv_sec = ms / 1000;
  tv.tv_usec = (ms % 1000) * 1000;
  if (::setsockopt(c->fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv)) != 0)
    return -1;
  return ::setsockopt(c->fd, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof(tv));
}

// pull: returns the center version (>= 0) or -1 on transport failure
int64_t dkps_client_pull(void* h, float* out) {
  auto* c = static_cast<Client*>(h);
  uint8_t action = 1;
  uint64_t version;
  if (!send_all(c->fd, &action, 1) || !recv_all(c->fd, &version, 8) ||
      !recv_all(c->fd, out, c->n * sizeof(float)))
    return -1;
  return static_cast<int64_t>(version);
}

int dkps_client_commit(void* h, const float* buf) {
  auto* c = static_cast<Client*>(h);
  uint8_t action = 2;
  uint8_t ack = 0;
  if (!send_all(c->fd, &action, 1) ||
      !send_all(c->fd, buf, c->n * sizeof(float)) ||
      !recv_all(c->fd, &ack, 1) || ack != 1)
    return -1;
  return 0;
}

// int8 commit: `q` is the full n-byte quantized vector, segmented into
// `segs` runs of `lens[i]` values sharing `scales[i]` (per-leaf scales on
// the Python side). One gathered header buffer, then the payload.
int dkps_client_commit_int8(void* h, const int8_t* q, const uint64_t* lens,
                            const float* scales, uint32_t segs) {
  auto* c = static_cast<Client*>(h);
  std::vector<char> header(1 + 4 + static_cast<size_t>(segs) * 12);
  header[0] = 4;
  std::memcpy(header.data() + 1, &segs, 4);
  char* p = header.data() + 5;
  for (uint32_t i = 0; i < segs; ++i) {
    std::memcpy(p, &lens[i], 8);
    std::memcpy(p + 8, &scales[i], 4);
    p += 12;
  }
  uint8_t ack = 0;
  if (!send_all(c->fd, header.data(), header.size()) ||
      !send_all(c->fd, q, c->n) || !recv_all(c->fd, &ack, 1) || ack != 1)
    return -1;
  return 0;
}

// seq'd commit (action 7): per-worker seqno dedup server-side — safe to
// replay after a torn connection. Returns 0 = folded, 1 = duplicate
// (already applied; the retry layer treats both as success), -1 =
// transport failure.
int dkps_client_commit_seq(void* h, uint64_t seq, const float* buf) {
  auto* c = static_cast<Client*>(h);
  char header[1 + 8];
  header[0] = 7;
  std::memcpy(header + 1, &seq, 8);
  uint8_t ack = 0;
  if (!send_all(c->fd, header, sizeof(header)) ||
      !send_all(c->fd, buf, c->n * sizeof(float)) ||
      !recv_all(c->fd, &ack, 1) || (ack != 1 && ack != 2))
    return -1;
  return ack == 2 ? 1 : 0;
}

// fenced + seq'd commit (action 10): the failover-safe commit. Returns
// 0 = folded, 1 = duplicate (both success to the retry layer), 2 =
// FENCED (the server's epoch differs — NOT folded; the caller raises a
// typed fatal/re-resolve error), -1 = transport failure. The server's
// current epoch lands in *server_epoch when non-null.
int dkps_client_commit_seq_e(void* h, uint64_t epoch, uint64_t seq,
                             const float* buf, uint64_t* server_epoch) {
  auto* c = static_cast<Client*>(h);
  char header[1 + 8 + 8];
  header[0] = 10;
  std::memcpy(header + 1, &epoch, 8);
  std::memcpy(header + 9, &seq, 8);
  uint8_t ack = 0;
  uint64_t sepoch = 0;
  if (!send_all(c->fd, header, sizeof(header)) ||
      !send_all(c->fd, buf, c->n * sizeof(float)) ||
      !recv_all(c->fd, &ack, 1) || !recv_all(c->fd, &sepoch, 8) ||
      (ack != 1 && ack != 2 && ack != 3))
    return -1;
  if (server_epoch) *server_epoch = sepoch;
  return ack == 3 ? 2 : (ack == 2 ? 1 : 0);
}

// fence (action 9): raise the server's fencing epoch. Returns the
// post-fence epoch (>= the requested one) or -1 on transport failure.
int64_t dkps_client_fence(void* h, uint64_t epoch) {
  auto* c = static_cast<Client*>(h);
  char header[1 + 8];
  header[0] = 9;
  std::memcpy(header + 1, &epoch, 8);
  uint8_t ack = 0;
  uint64_t now_epoch = 0;
  if (!send_all(c->fd, header, sizeof(header)) ||
      !recv_all(c->fd, &ack, 1) || ack != 1 ||
      !recv_all(c->fd, &now_epoch, 8))
    return -1;
  return static_cast<int64_t>(now_epoch);
}

// shard-map handshake (SHARD_INFO, action 11): which shard of which
// partition this server holds. Returns 0 on success (*out_num == 0 means
// the server is unsharded), -1 on transport failure.
int dkps_client_shard_info(void* h, uint32_t* out_shard, uint32_t* out_num,
                           uint64_t* out_epoch) {
  auto* c = static_cast<Client*>(h);
  uint8_t action = 11;
  uint32_t info[2] = {0, 0};
  uint64_t epoch = 0;
  if (!send_all(c->fd, &action, 1) || !recv_all(c->fd, info, 8) ||
      !recv_all(c->fd, &epoch, 8))
    return -1;
  if (out_shard) *out_shard = info[0];
  if (out_num) *out_num = info[1];
  if (out_epoch) *out_epoch = epoch;
  return 0;
}

// heartbeat (action 6): renew this worker's lease, reporting the client's
// cumulative retry count. Returns 1 = renewed, 0 = (re-)registered,
// -1 = transport failure.
int dkps_client_heartbeat(void* h, uint32_t retries) {
  auto* c = static_cast<Client*>(h);
  char header[1 + 4];
  header[0] = 6;
  std::memcpy(header + 1, &retries, 4);
  uint8_t ack = 0;
  if (!send_all(c->fd, header, sizeof(header)) ||
      !recv_all(c->fd, &ack, 1) || (ack != 1 && ack != 2))
    return -1;
  return ack == 1 ? 1 : 0;
}

// elastic live-join (action 12): lease this worker mid-run. Fills
// *out_updates / *out_pool with the server's current fold count and
// post-join pool gauge. Returns 0 on success, -1 on transport failure.
int dkps_client_join(void* h, uint64_t* out_updates, uint64_t* out_pool) {
  auto* c = static_cast<Client*>(h);
  uint8_t action = 12;
  uint8_t ack = 0;
  uint64_t updates = 0, pool = 0;
  if (!send_all(c->fd, &action, 1) || !recv_all(c->fd, &ack, 1) ||
      ack != 1 || !recv_all(c->fd, &updates, 8) ||
      !recv_all(c->fd, &pool, 8))
    return -1;
  if (out_updates) *out_updates = updates;
  if (out_pool) *out_pool = pool;
  return 0;
}

// preemption drain (action 13): clean deregister + elastic counters;
// timed_out != 0 records a deadline-lapsed drain. 0 on success.
int dkps_client_drain(void* h, uint8_t timed_out) {
  auto* c = static_cast<Client*>(h);
  char header[2];
  header[0] = 13;
  header[1] = static_cast<char>(timed_out ? 1 : 0);
  uint8_t ack = 0;
  if (!send_all(c->fd, header, 2) || !recv_all(c->fd, &ack, 1) || ack != 1)
    return -1;
  return 0;
}

// trace scrape (action 15): drain the server's span ring into
// `out` (room for max_recs records of 5 u64: kind, wid, seq, t0_ns,
// dur_ns). Returns the record count written (the remainder of an
// overfull ring is read off the wire and discarded so the stream stays
// framed), or -1 on transport failure.
int64_t dkps_client_trace_scrape(void* h, uint64_t* out,
                                 uint64_t max_recs) {
  auto* c = static_cast<Client*>(h);
  uint8_t action = 15;
  uint64_t cnt = 0;
  if (!send_all(c->fd, &action, 1) || !recv_all(c->fd, &cnt, 8))
    return -1;
  const uint64_t keep = cnt < max_recs ? cnt : max_recs;
  if (keep && !recv_all(c->fd, out, keep * 5 * 8)) return -1;
  uint64_t left = (cnt - keep) * 5 * 8;
  char sink[4096];
  while (left) {
    const uint64_t k = left < sizeof(sink) ? left : sizeof(sink);
    if (!recv_all(c->fd, sink, k)) return -1;
    left -= k;
  }
  return static_cast<int64_t>(keep);
}

// deregister (action 8): clean exit — drop the lease, no eviction counted
int dkps_client_deregister(void* h) {
  auto* c = static_cast<Client*>(h);
  uint8_t action = 8;
  uint8_t ack = 0;
  if (!send_all(c->fd, &action, 1) || !recv_all(c->fd, &ack, 1) || ack != 1)
    return -1;
  return 0;
}

// compressed pull (action 5): decodes the block-quantized reply into `out`
// (n floats). Returns the center version (>= 0) or -1 on transport failure
// or a malformed reply. The server holds this worker's quantization
// residual, so repeated compressed pulls telescope to the exact center.
int64_t dkps_client_pull_int8(void* h, float* out) {
  auto* c = static_cast<Client*>(h);
  uint8_t action = 5;
  uint64_t version;
  uint32_t nb;
  const uint64_t expect_nb = pull_blocks(c->n);
  if (!send_all(c->fd, &action, 1) || !recv_all(c->fd, &version, 8) ||
      !recv_all(c->fd, &nb, 4) || nb != expect_nb)
    return -1;
  std::vector<float> scales(nb);
  std::vector<int8_t> q(c->n);
  if (!recv_all(c->fd, scales.data(), nb * sizeof(float)) ||
      !recv_all(c->fd, q.data(), c->n))
    return -1;
  for (uint64_t b = 0; b < nb; ++b) {
    const uint64_t lo = b * kPullBlock;
    const uint64_t hi = std::min(lo + kPullBlock, c->n);
    const float s = scales[b];
    for (uint64_t i = lo; i < hi; ++i)
      out[i] = s * static_cast<float>(q[i]);
  }
  return static_cast<int64_t>(version);
}

// fused exchange (action 14): fold the commit and read the fresh
// post-fold center in ONE round trip. flags: bit0 carry `seq` (dedup),
// bit1 carry `epoch` (fencing), bit2 int8 pull reply, bit3 lag (price
// tau from the previous pull version — the pipelined worker's honest
// staleness). Returns the post-fold center version (>= 0; duplicate
// folds return the fresh center too), -2 = FENCED (not folded; the
// server's epoch lands in *server_epoch), -1 = transport failure.
int64_t dkps_client_exchange(void* h, uint8_t flags, uint64_t epoch,
                             uint64_t seq, const float* commit, float* out,
                             uint64_t* server_epoch) {
  auto* c = static_cast<Client*>(h);
  char header[1 + 1 + 8 + 8];
  size_t hl = 0;
  header[hl++] = 14;
  header[hl++] = static_cast<char>(flags);
  if (flags & 2) {
    std::memcpy(header + hl, &epoch, 8);
    hl += 8;
  }
  if (flags & 1) {
    std::memcpy(header + hl, &seq, 8);
    hl += 8;
  }
  uint8_t ack = 0;
  uint64_t sepoch = 0, version = 0;
  if (!send_all(c->fd, header, hl) ||
      !send_all(c->fd, commit, c->n * sizeof(float)) ||
      !recv_all(c->fd, &ack, 1) || !recv_all(c->fd, &sepoch, 8) ||
      (ack != 1 && ack != 2 && ack != 3))
    return -1;
  if (server_epoch) *server_epoch = sepoch;
  if (ack == 3) return -2;
  if (!recv_all(c->fd, &version, 8)) return -1;
  if (!(flags & 4)) {
    if (!recv_all(c->fd, out, c->n * sizeof(float))) return -1;
    return static_cast<int64_t>(version);
  }
  uint32_t nb;
  const uint64_t expect_nb = pull_blocks(c->n);
  if (!recv_all(c->fd, &nb, 4) || nb != expect_nb) return -1;
  std::vector<float> scales(nb);
  std::vector<int8_t> q(c->n);
  if (!recv_all(c->fd, scales.data(), nb * sizeof(float)) ||
      !recv_all(c->fd, q.data(), c->n))
    return -1;
  for (uint64_t b = 0; b < nb; ++b) {
    const uint64_t lo = b * kPullBlock;
    const uint64_t hi = std::min(lo + kPullBlock, c->n);
    const float s = scales[b];
    for (uint64_t i = lo; i < hi; ++i)
      out[i] = s * static_cast<float>(q[i]);
  }
  return static_cast<int64_t>(version);
}

void dkps_client_close(void* h) {
  auto* c = static_cast<Client*>(h);
  uint8_t action = 3;
  send_all(c->fd, &action, 1);
  close_conn_fd(c->fd);
  delete c;
}

}  // extern "C"
