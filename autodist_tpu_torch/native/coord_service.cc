// Coordination service: TCP key/value + counters + barriers + a binary
// tensor data plane.
//
// TPU-native replacement for the control-plane primitives the reference
// gets from the TF C++ runtime (SURVEY.md §2.2): FIFO token queues for
// sync barriers and bounded staleness (ps_synchronizer.py:335-458) and
// the chief/worker rendezvous that tf.Server+grpc provided. SPMD
// collectives need none of this inside a program; this service covers the
// *between-program* coordination: multi-process barriers, bounded-
// staleness windows (each worker publishes its step; a worker may run
// ahead only while min_step >= my_step - staleness), heartbeats for
// fail-fast monitoring, and small metadata exchange (strategy ids).
//
// The binary tensor commands (BSET/BGET/BADD/BSTEP, and the row-sparse
// BSADD/BGETROWS) are the PS data
// plane: the reference aggregates cross-worker gradients in
// ConditionalAccumulators living on the PS task and rides TF's grpc
// data plane for the bytes (ps_synchronizer.py:556-633); here workers
// push deltas/gradients as length-prefixed raw frames (f32, bf16 or
// block-quantized i8 on the wire, f32 at rest) applied with an atomic
// elementwise add —
// commutative apply-per-push, which is exactly the reference's
// staleness>0 accumulator mode (take_grad(1): every push is applied).
// Each tensor has its OWN mutex, so a multi-MB push on one variable
// never serializes against another variable's pull; a run hosts one
// service per PS endpoint (ps_lb_strategy.py:64-83 bin-packing made
// load-bearing: variables land on the endpoint their
// reduction_destination resolves to, per SHARD for partitioned
// variables — partitioned_ps_strategy.py:89-96 round-robin placement).
//
// All B* commands accept an optional trailing `<off_elems> <total_elems>`
// range so large tensors move as bounded chunks (the client splits
// frames above AUTODIST_PS_CHUNK_BYTES): every update rule here is
// elementwise, so ranged application is exact. A logical push counts
// once, at its offset-0 chunk.
//
// Row-sparse tensor protocol (embedding variables): a push whose delta
// touches few rows of a [rows, cols] table ships ONLY those rows.
// BSADD's payload is `<nrows> little-endian int32 row indices ||
// <nrows> rows of wire data` (row_bytes wire bytes per row; cols =
// row_bytes / wire itemsize), applied as a scatter-add into the stored
// tensor under its lock — addition commutes, so concurrent sparse and
// dense pushes interleave exactly, and a delta whose untouched rows
// are exactly zero loses nothing by dropping them. The optional
// `<off> <total>` range counts ROWS of the logical push (the client
// splits large row sets into chunks); fencing, the torn-read version
// counter and chunk-sequence aborts behave exactly like BADD. BGETROWS
// returns just the listed rows (its request payload is the int32
// index vector), for refreshing a worker's proxy cache after a sparse
// push without refetching the whole table.
//
// BSTEP keeps the optimizer step ON the PS (the reference re-creates
// the user's optimizer over PS-resident variables so async workers
// share slot state, kernel/partitioner.py:570-573): workers push raw
// gradients and the service applies the named update rule with PS-
// resident slots shared by all workers. Rules (optax-matching forms):
//   sgd      p0=lr p1=momentum   vel = m*vel + g; w -= lr*vel
//   adam     p0=lr p1=b1 p2=b2 p3=eps
//            m=b1*m+(1-b1)g; v=b2*v+(1-b2)g^2;
//            w -= lr * (m/(1-b1^t)) / (sqrt(v/(1-b2^t)) + eps)
//   adagrad  p0=lr p1=eps p2=init_acc
//            acc += g^2; w -= lr * g / (sqrt(acc) + eps)
// The adam step index t is shared: a push's offset-0 chunk with t=0
// bumps the tensor's counter and the reply returns the t used; later
// chunks of the same push pass that t explicitly.
//
// Authentication: when the service is started with AUTODIST_COORD_TOKEN
// set, every connection is greeted with `HELLO <nonce>` and must present
// `AUTH <hex hmac-sha256(token, nonce)>` before any other command
// (without a token the greeting is `HELLO open`). The reference's
// control plane rode authenticated SSH (coordinator.py:46-90); an open
// TCP port on a multi-host NIC needs at least this shared-secret
// handshake.
//
// Protocol: newline-terminated text commands over TCP; the B* commands
// carry a length-prefixed raw payload immediately after the newline.
// Writer fencing (elastic recovery): `FENCE <key> <gen>` binds the
// connection to generation <gen> of the counter <key>. Once that
// counter advances past the bound generation (a survivor or the
// supervising coordinator declared this writer dead and bumped it),
// every mutating command on the connection — SET, DEL, DELNS, INCR,
// BSET, BADD, BSADD, BSTEP — is rejected with `ERR fenced`, so a zombie can
// never corrupt state after its replacement joins under a fresh
// generation. Reads and waits stay open (a zombie observing the world
// is harmless; only its writes are dangerous).
//
//   AUTH <hmac-hex>              -> OK | ERR (connection greeting reply)
//   FENCE <key> <gen>            -> OK | ERR fenced (bind this
//                                    connection's writer generation)
//   SET <key> <value>            -> OK
//   GET <key>                    -> VAL <value> | NONE
//   DEL <key>                    -> OK
//   DELNS <prefix>               -> VAL <n>  (purge keys/counters/tensors
//                                    /barriers under prefix: run-end
//                                    cleanup for long-lived endpoints)
//   INCR <key> <delta>           -> VAL <n>        (atomic add, int64)
//   WAITGE <key> <n> <ms>        -> VAL <m> | TIMEOUT   (wait key >= n)
//   MINWAIT <prefix> <n> <k> <ms>-> VAL <min> | TIMEOUT
//       (wait until >=k keys share <prefix> and their min value >= n)
//   BARRIER <name> <k> <ms>      -> OK | TIMEOUT   (k-party barrier)
//   BSET <key> <nbytes> <wire> [<off> <total>]  [payload] -> OK
//       (store tensor; wire dtype f32|bf16|i8, stored as f32. The i8
//        wire is the blockscale format: `u32 block, u32 n, f32 scales
//        x ceil(n/block), int8 q x n` — one f32 scale per `block`
//        int8 values, value[i] = q[i] * scale[i/block]. The block
//        size rides in the frame itself, so any client block size
//        (AUTODIST_QUANT_BLOCK) decodes)
//   BGET <key> <wire> [<off> <count>] [v] -> VAL <nbytes> [<ver>]\n
//       [payload] | NONE   ("v" opts into <ver> = version*2 +
//        write_in_progress; odd or chunk-to-chunk-changing ver = torn
//        read, client retries)
//   BADD <key> <nbytes> <wire> [<off> <total>]  [payload] -> VAL <n>
//       (atomic elementwise += ; creates the tensor if absent; returns
//        the tensor's accumulated push count)
//   BSADD <key> <nrows> <row_bytes> <wire> [<off> <total>]  [payload]
//       -> VAL <n>   (row-sparse scatter-add: payload is <nrows> int32
//        row indices then <nrows> rows of wire data; <off>/<total>
//        count ROWS of the logical push; tensor must already exist.
//        For the i8 wire, <row_bytes> is the TOTAL byte length of the
//        encoded rows blob — blockscale frames carry a scales header,
//        so their size is not per-row divisible — and cols is derived
//        from decoded elements / nrows; f32/bf16 keep the per-row
//        meaning)
//   BGETROWS <key> <nrows> <ncols> <wire> [v]  [payload] -> VAL
//       <nbytes> [<ver>]\n[payload]  | NONE   (fetch just the rows
//        listed in the int32 request payload; "v" = version field,
//        same torn-read semantics as BGET)
//   BSTAT <key>                  -> VAL <pushes> <steps> <elems>
//                                   <slot1> <slot2> | NONE
//   BSTEP <key> <nbytes> <wire> <rule> <t> <p0> <p1> <p2> <p3>
//         [<off> <total>]        [payload] -> VAL <t_used>
//   PING                         -> PONG
//   SHUTDOWN                     -> OK (server exits)
//
// Build: g++ -O3 -std=c++17 -pthread -o coord_service coord_service.cc

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <random>
#include <set>
#include <sstream>
#include <string>
#include <string_view>
#include <thread>
#include <vector>

namespace {

// Declared payload sizes above this are refused outright (ADVICE r3:
// an unvalidated size_t let a malformed header buffer unbounded bytes).
constexpr uint64_t kMaxPayload = 1ULL << 32;  // 4 GB per frame
constexpr size_t kBadPayload = static_cast<size_t>(-1);

// A stored tensor. `mu` serializes element updates per KEY (not
// globally): the scoped-allocator-scale concern of one global lock over
// all variables does not exist here.
struct Tensor {
  std::mutex mu;
  std::vector<float> data;
  std::vector<float> slot1;  // PS-resident momentum / adam first moment
  std::vector<float> slot2;  // adam second moment / adagrad accumulator
  int64_t pushes = 0;
  int64_t steps = 0;  // BSTEP optimizer-step counter (adam bias t)
  // Torn-read detection (ADVICE r4).  `version` bumps on every
  // mutating frame (each BSET chunk, BADD, BSTEP); `open_writes`
  // counts chunked write sequences in flight (first chunk ++, final
  // chunk --, so a single whole-tensor frame nets 0 inside its own
  // lock hold).  A BGET that opts in (trailing "v") gets
  // `version*2 + (open_writes>0)` in its reply: an odd value or a
  // value that moves across a reader's chunks means the read raced a
  // writer and must be retried.  Every error reply closes the sequence
  // it opened (abort), so a rejected write cannot wedge the counter,
  // and a writer whose CONNECTION dies mid-sequence has its open
  // sequences aborted at disconnect (serve_conn's SeqAborter) — only a
  // writer alive-but-stalled past the client's stall window surfaces
  // to readers as a stalled-odd error rather than torn data.
  int64_t version = 0;
  int64_t open_writes = 0;
};

struct Store {
  std::mutex mu;
  std::condition_variable cv;
  std::map<std::string, std::string> kv;
  std::map<std::string, int64_t> counters;
  std::map<std::string, int64_t> barrier_arrivals;
  std::map<std::string, int64_t> barrier_generation;
  std::map<std::string, std::shared_ptr<Tensor>> tensors;
  std::atomic<bool> shutting_down{false};
};

Store g_store;
std::string g_token;  // empty = open service (loopback-only deployments)

// Per-connection writer fencing. A connection that bound itself to a
// fence counter via FENCE is a generation-g writer; once the counter
// advances past g every mutating command on the connection is
// rejected. Unfenced connections (fence_key empty) write freely — the
// pre-recovery protocol, and reads never fence.
struct ConnState {
  std::string fence_key;
  int64_t fence_gen = 0;
  // Chunked write sequences THIS connection opened (offset-0 frame
  // seen, final chunk not yet) — touched only by the connection's own
  // serving thread. Aborted when the connection dies: a writer killed
  // between chunks (the exclude/restart policies' died-mid-push case)
  // sends no further frames, so without this the sequence would hold
  // open_writes forever and wedge every reader on odd parity until a
  // DELNS. TCP teardown (os._exit, host crash with RST, clean close)
  // lands here as read_line/recv failure.
  std::set<std::string> open_seqs;
};

constexpr const char* kFencedErr = "ERR fenced stale generation";

// True when the connection's bound generation has been superseded.
// Caller must hold g_store.mu. The KV/counter mutations check under
// the SAME mu hold as the mutation itself — a separate check-then-act
// would let one in-flight zombie frame commit after its fence bump.
bool is_fenced_locked(const ConnState& conn) {
  if (conn.fence_key.empty()) return false;
  auto it = g_store.counters.find(conn.fence_key);
  int64_t cur = it == g_store.counters.end() ? 0 : it->second;
  return cur > conn.fence_gen;
}

// Locking variant. Takes g_store.mu; safe to call while holding a
// tensor mutex (nothing acquires a tensor mutex under g_store.mu), so
// the B* handlers re-check AFTER taking the tensor lock: once a fence
// bump's INCR has been processed, no later-processed frame from the
// stale writer can mutate the tensor.
bool is_fenced(const ConnState& conn) {
  if (conn.fence_key.empty()) return false;
  std::lock_guard<std::mutex> l(g_store.mu);
  return is_fenced_locked(conn);
}

// Bookkeeping for one mutating frame of a (possibly chunked) write
// sequence — the single place the open_writes invariant lives for
// BSET/BADD/BSTEP.  Construct AFTER locking the tensor: the offset-0
// frame opens the sequence.  Call fail(e) on any rejection (aborts the
// sequence, so a malformed or mismatched frame cannot wedge readers on
// a permanently-odd version), finish() after a successful mutation
// (closes the sequence on its final chunk and bumps the version).
struct SeqFrame {
  Tensor* t;
  ConnState* conn;
  const std::string& key;
  SeqFrame(Tensor* t, size_t off, ConnState* conn, const std::string& key)
      : t(t), conn(conn), key(key) {
    if (off == 0) {
      ++t->open_writes;
      conn->open_seqs.insert(key);
    }
  }
  std::string fail(const char* e) {
    if (t->open_writes > 0) --t->open_writes;
    conn->open_seqs.erase(key);
    return e;
  }
  void finish(bool final_chunk) {
    if (final_chunk) {
      if (t->open_writes > 0) --t->open_writes;
      conn->open_seqs.erase(key);
    }
    ++t->version;
  }
};

std::shared_ptr<Tensor> find_tensor(const std::string& key, bool create) {
  std::lock_guard<std::mutex> l(g_store.mu);
  auto it = g_store.tensors.find(key);
  if (it != g_store.tensors.end()) return it->second;
  if (!create) return nullptr;
  auto t = std::make_shared<Tensor>();
  g_store.tensors[key] = t;
  return t;
}

// A CONTINUATION frame (declared offset > 0) rejected before its tensor
// lock (bad payload / bad range) still aborts the sequence its writer
// opened at offset 0 — otherwise one malformed chunk would wedge the
// key's readers on a permanently-odd version until DELNS removes the
// tensor. Only continuation chunks qualify: an offset-0 (or offsetless,
// or unparsable-offset) frame rejected here never opened a sequence —
// SeqFrame is constructed after these checks — so decrementing for it
// would close ANOTHER writer's in-flight chunked sequence and clear the
// torn-read parity bit under that writer's feet. `off_declared` is the
// frame's raw declared offset (-1 when absent/unparsable).
std::string abort_open_seq(ConnState* conn, const std::string& key,
                           int64_t off_declared, const char* e) {
  if (off_declared <= 0) return e;
  conn->open_seqs.erase(key);
  std::shared_ptr<Tensor> t = find_tensor(key, /*create=*/false);
  if (t) {
    std::lock_guard<std::mutex> l(t->mu);
    if (t->open_writes > 0) --t->open_writes;
  }
  return e;
}

// Disconnect-time abort of every sequence the connection still holds
// open: a writer that died mid-chunked-push will never send the final
// chunk, and its readers must not stay wedged on odd parity until a
// DELNS. Same semantics as the per-frame aborts — release the
// open_writes slot, leave the (partial) data for the staleness model
// to absorb like any other bounded-lag contribution.
void abort_conn_seqs(ConnState* conn) {
  for (const std::string& key : conn->open_seqs) {
    std::shared_ptr<Tensor> t = find_tensor(key, /*create=*/false);
    if (!t) continue;
    std::lock_guard<std::mutex> l(t->mu);
    if (t->open_writes > 0) --t->open_writes;
  }
  conn->open_seqs.clear();
}

// Fencing re-check for the B* handlers, run AFTER taking the tensor
// lock (caller holds t->mu): the wire-entry is_fenced check alone is
// not enough — a fence bump landing between it and the tensor lock
// would let one in-flight zombie frame commit after its exclusion
// became observable. Inlines the sequence abort (abort_open_seq would
// re-lock t->mu): a fenced continuation chunk releases the open_writes
// slot its sequence holds so readers are not wedged on odd parity.
bool reject_fenced_under_tensor_lock(ConnState* conn,
                                     const std::string& key, Tensor* t,
                                     int64_t off_decl) {
  if (!is_fenced(*conn)) return false;
  if (off_decl > 0 && t->open_writes > 0) {
    --t->open_writes;
    conn->open_seqs.erase(key);
  }
  return true;
}

// The raw declared offset of a B* command's optional trailing
// `<off> <total>` range, parsed WITHOUT validation (the frame is
// already being rejected; this only decides whether it could have been
// a continuation chunk of an open sequence). -1 when absent or
// unparsable. Restores the stream position so read_range (in the
// accept path) is unaffected.
int64_t declared_offset(std::istringstream* in) {
  in->clear();   // a rangeless header leaves eofbit set from the parse
  std::streampos pos = in->tellg();
  int64_t o = -1;
  // parse the offset ALONE: a continuation frame whose total token is
  // corrupt ("5 garbage") must still abort its own open sequence
  if (!(*in >> o)) o = -1;
  in->clear();
  if (pos != std::streampos(-1)) in->seekg(pos);
  return o;
}

// -- sha256 / hmac (handshake) -----------------------------------------------
// Compact FIPS-180-4 SHA-256; no external crypto dependency.

struct Sha256 {
  uint32_t h[8];
  uint8_t buf[64];
  uint64_t len = 0;
  size_t fill = 0;

  Sha256() {
    static const uint32_t init[8] = {
        0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
        0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19};
    memcpy(h, init, sizeof(h));
  }

  static uint32_t rotr(uint32_t x, int n) {
    return (x >> n) | (x << (32 - n));
  }

  void block(const uint8_t* p) {
    static const uint32_t k[64] = {
        0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b,
        0x59f111f1, 0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01,
        0x243185be, 0x550c7dc3, 0x72be5d74, 0x80deb1fe, 0x9bdc06a7,
        0xc19bf174, 0xe49b69c1, 0xefbe4786, 0x0fc19dc6, 0x240ca1cc,
        0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da, 0x983e5152,
        0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
        0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc,
        0x53380d13, 0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85,
        0xa2bfe8a1, 0xa81a664b, 0xc24b8b70, 0xc76c51a3, 0xd192e819,
        0xd6990624, 0xf40e3585, 0x106aa070, 0x19a4c116, 0x1e376c08,
        0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a, 0x5b9cca4f,
        0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
        0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};
    uint32_t w[64];
    for (int i = 0; i < 16; ++i)
      w[i] = (uint32_t(p[i * 4]) << 24) | (uint32_t(p[i * 4 + 1]) << 16) |
             (uint32_t(p[i * 4 + 2]) << 8) | uint32_t(p[i * 4 + 3]);
    for (int i = 16; i < 64; ++i) {
      uint32_t s0 = rotr(w[i - 15], 7) ^ rotr(w[i - 15], 18) ^
                    (w[i - 15] >> 3);
      uint32_t s1 = rotr(w[i - 2], 17) ^ rotr(w[i - 2], 19) ^
                    (w[i - 2] >> 10);
      w[i] = w[i - 16] + s0 + w[i - 7] + s1;
    }
    uint32_t a = h[0], b = h[1], c = h[2], d = h[3];
    uint32_t e = h[4], f = h[5], g = h[6], hh = h[7];
    for (int i = 0; i < 64; ++i) {
      uint32_t s1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
      uint32_t ch = (e & f) ^ (~e & g);
      uint32_t t1 = hh + s1 + ch + k[i] + w[i];
      uint32_t s0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
      uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
      uint32_t t2 = s0 + maj;
      hh = g; g = f; f = e; e = d + t1;
      d = c; c = b; b = a; a = t1 + t2;
    }
    h[0] += a; h[1] += b; h[2] += c; h[3] += d;
    h[4] += e; h[5] += f; h[6] += g; h[7] += hh;
  }

  void update(const void* data, size_t n) {
    const uint8_t* p = static_cast<const uint8_t*>(data);
    len += n;
    while (n) {
      size_t take = std::min(n, sizeof(buf) - fill);
      memcpy(buf + fill, p, take);
      fill += take; p += take; n -= take;
      if (fill == sizeof(buf)) { block(buf); fill = 0; }
    }
  }

  void final(uint8_t out[32]) {
    uint64_t bits = len * 8;
    uint8_t pad = 0x80;
    update(&pad, 1);
    uint8_t zero = 0;
    while (fill != 56) update(&zero, 1);
    uint8_t lenb[8];
    for (int i = 0; i < 8; ++i) lenb[i] = uint8_t(bits >> (56 - 8 * i));
    update(lenb, 8);
    for (int i = 0; i < 8; ++i) {
      out[i * 4] = uint8_t(h[i] >> 24);
      out[i * 4 + 1] = uint8_t(h[i] >> 16);
      out[i * 4 + 2] = uint8_t(h[i] >> 8);
      out[i * 4 + 3] = uint8_t(h[i]);
    }
  }
};

void hmac_sha256(const std::string& key, const std::string& msg,
                 uint8_t out[32]) {
  uint8_t k[64] = {0};
  if (key.size() > 64) {
    Sha256 s; s.update(key.data(), key.size()); s.final(k);
  } else {
    memcpy(k, key.data(), key.size());
  }
  uint8_t ipad[64], opad[64];
  for (int i = 0; i < 64; ++i) { ipad[i] = k[i] ^ 0x36; opad[i] = k[i] ^ 0x5c; }
  uint8_t inner[32];
  Sha256 si; si.update(ipad, 64); si.update(msg.data(), msg.size());
  si.final(inner);
  Sha256 so; so.update(opad, 64); so.update(inner, 32); so.final(out);
}

std::string to_hex(const uint8_t* p, size_t n) {
  static const char* d = "0123456789abcdef";
  std::string out(n * 2, '0');
  for (size_t i = 0; i < n; ++i) {
    out[2 * i] = d[p[i] >> 4];
    out[2 * i + 1] = d[p[i] & 15];
  }
  return out;
}

// Returns 32 hex chars of OS entropy, or "" when no unpredictable
// source exists.  NO predictable fallback (ADVICE r4): a clock+pid
// nonce makes the HMAC challenge replayable, so the caller must fail
// closed (refuse the authenticated connection) on "".
std::string make_nonce() {
  uint8_t raw[16];
  size_t got = 0;
  FILE* f = fopen("/dev/urandom", "rb");
  if (f) {
    got = fread(raw, 1, sizeof(raw), f);
    fclose(f);
  }
  if (got != sizeof(raw)) {
    try {
      std::random_device rd;  // getrandom()/RDRAND-backed on Linux
      for (size_t i = 0; i < sizeof(raw); i += 4) {
        uint32_t v = rd();
        memcpy(raw + i, &v, sizeof(v));
      }
      got = sizeof(raw);
    } catch (...) {
      return "";
    }
  }
  return to_hex(raw, sizeof(raw));
}

bool constant_time_eq(const std::string& a, const std::string& b) {
  if (a.size() != b.size()) return false;
  unsigned char diff = 0;
  for (size_t i = 0; i < a.size(); ++i) diff |= a[i] ^ b[i];
  return diff == 0;
}

// -- wire dtypes -------------------------------------------------------------

// Branch-free (a select, not a branch) so the element loops in
// encode_wire/decode_wire auto-vectorize — the conversion competes
// with socket I/O for the same cores under multi-worker contention,
// where a scalar loop measurably cost more than the bf16 byte saving
// bought (BASELINE.md round-4 bf16 row, fixed round 5).
uint16_t f32_to_bf16(float f) {
  uint32_t u;
  memcpy(&u, &f, 4);
  // round-to-nearest-even, like XLA's f32->bf16 convert; NaN must not
  // round into Inf, so select the quieted-NaN form instead
  uint32_t bias = 0x7fff + ((u >> 16) & 1);
  uint16_t rtne = static_cast<uint16_t>((u + bias) >> 16);
  uint16_t qnan = static_cast<uint16_t>((u >> 16) | 0x0040);
  return (u & 0x7fffffffu) > 0x7f800000u ? qnan : rtne;
}

float bf16_to_f32(uint16_t h) {
  uint32_t u = static_cast<uint32_t>(h) << 16;
  float f;
  memcpy(&f, &u, 4);
  return f;
}

// Block size for i8 frames this service ENCODES (BGET replies); frames
// it decodes carry their own block size in the header. Read once: the
// env is fixed for the process lifetime, like the auth token.
size_t i8_encode_block() {
  static const size_t block = [] {
    const char* raw = getenv("AUTODIST_QUANT_BLOCK");
    long v = raw ? atol(raw) : 0;
    return v >= 8 ? static_cast<size_t>(v) : static_cast<size_t>(256);
  }();
  return block;
}

// wire "f32": payload is raw little-endian float32; "bf16": raw uint16
// upper halves of float32; "i8": blockscale frame `u32 block, u32 n,
// f32 scales x ceil(n/block), int8 q x n` (value = q * per-block
// scale). Returns false on a malformed payload.
bool decode_wire(std::string_view payload, const std::string& wire,
                 std::vector<float>* out) {
  if (wire == "f32") {
    if (payload.size() % 4) return false;
    out->resize(payload.size() / 4);
    memcpy(out->data(), payload.data(), payload.size());
    return true;
  }
  if (wire == "bf16") {
    if (payload.size() % 2) return false;
    size_t n = payload.size() / 2;
    out->resize(n);
    const uint16_t* src =
        reinterpret_cast<const uint16_t*>(payload.data());
    for (size_t i = 0; i < n; ++i) (*out)[i] = bf16_to_f32(src[i]);
    return true;
  }
  if (wire == "i8") {
    if (payload.size() < 8) return false;
    uint32_t block = 0, n = 0;
    memcpy(&block, payload.data(), 4);
    memcpy(&n, payload.data() + 4, 4);
    if (block == 0) return false;
    const size_t nb = (static_cast<size_t>(n) + block - 1) / block;
    if (payload.size() != 8 + nb * 4 + n) return false;
    std::vector<float> scales(nb);
    if (nb) memcpy(scales.data(), payload.data() + 8, nb * 4);
    const int8_t* q =
        reinterpret_cast<const int8_t*>(payload.data() + 8 + nb * 4);
    out->resize(n);
    // block-strided inner loop (contiguous, constant scale) so the
    // dequant auto-vectorizes like the bf16 path — same contention
    // lesson (BASELINE.md round-4 bf16 row)
    for (size_t b = 0; b < nb; ++b) {
      const float s = scales[b];
      const size_t lo = b * block;
      const size_t hi = std::min(lo + block, static_cast<size_t>(n));
      for (size_t i = lo; i < hi; ++i)
        (*out)[i] = static_cast<float>(q[i]) * s;
    }
    return true;
  }
  return false;
}

bool encode_wire(const float* v, size_t n, const std::string& wire,
                 std::string* out) {
  if (wire == "f32") {
    out->assign(reinterpret_cast<const char*>(v), n * 4);
    return true;
  }
  if (wire == "bf16") {
    out->resize(n * 2);
    uint16_t* dst = reinterpret_cast<uint16_t*>(&(*out)[0]);
    for (size_t i = 0; i < n; ++i) dst[i] = f32_to_bf16(v[i]);
    return true;
  }
  if (wire == "i8") {
    const size_t block = i8_encode_block();
    const size_t nb = (n + block - 1) / block;
    out->resize(8 + nb * 4 + n);
    char* raw = &(*out)[0];
    const uint32_t block32 = static_cast<uint32_t>(block);
    const uint32_t n32 = static_cast<uint32_t>(n);
    memcpy(raw, &block32, 4);
    memcpy(raw + 4, &n32, 4);
    float* scales = reinterpret_cast<float*>(raw + 8);
    int8_t* q = reinterpret_cast<int8_t*>(raw + 8 + nb * 4);
    for (size_t b = 0; b < nb; ++b) {
      const size_t lo = b * block;
      const size_t hi = std::min(lo + block, n);
      float maxabs = 0.f;
      for (size_t i = lo; i < hi; ++i)
        maxabs = std::max(maxabs, std::fabs(v[i]));
      // the +1e-30f epsilon matches the Python encoder exactly (an
      // all-zero block must not divide by zero); round-to-nearest +
      // clamp as branch-free min/max selects so the loop vectorizes
      const float scale = maxabs / 127.0f + 1e-30f;
      const float inv = 1.0f / scale;
      scales[b] = scale;
      for (size_t i = lo; i < hi; ++i) {
        float r = std::nearbyintf(v[i] * inv);
        r = std::max(-127.0f, std::min(127.0f, r));
        q[i] = static_cast<int8_t>(r);
      }
    }
    return true;
  }
  return false;
}

int64_t counter_of(const std::string& key) {
  auto it = g_store.counters.find(key);
  return it == g_store.counters.end() ? 0 : it->second;
}

// min over counters with the prefix; count reported via out param.
int64_t prefix_min(const std::string& prefix, int* count) {
  int64_t min_v = INT64_MAX;
  int n = 0;
  for (auto it = g_store.counters.lower_bound(prefix);
       it != g_store.counters.end() &&
       it->first.compare(0, prefix.size(), prefix) == 0;
       ++it) {
    ++n;
    if (it->second < min_v) min_v = it->second;
  }
  *count = n;
  return n ? min_v : 0;
}

template <typename M>
size_t erase_prefix(M* m, const std::string& prefix) {
  size_t n = 0;
  auto it = m->lower_bound(prefix);
  while (it != m->end() &&
         it->first.compare(0, prefix.size(), prefix) == 0) {
    it = m->erase(it);
    ++n;
  }
  return n;
}

// Payload bytes that follow the header line, or 0 for text commands;
// kBadPayload for an unparsable or over-cap declaration.
size_t payload_size(const std::string& line) {
  std::istringstream in(line);
  std::string cmd, key;
  in >> cmd;
  if (cmd == "BSADD") {
    // <nrows> int32 indices + <nrows> rows of <row_bytes> wire bytes;
    // guard the product against uint64 wraparound before comparing to
    // the cap (a wrapped declaration must not buffer toward 2^64).
    // i8 frames declare row_bytes as the TOTAL rows-blob length (the
    // blockscale scales header makes the blob non-row-divisible), so
    // the payload is indices + exactly that many bytes.
    uint64_t nrows = 0, row_bytes = 0;
    std::string wire;
    in >> key >> nrows >> row_bytes >> wire;
    if (in.fail() || row_bytes > kMaxPayload) return kBadPayload;
    if (wire == "i8") {
      if (nrows > kMaxPayload / 4 ||
          nrows * 4 > kMaxPayload - row_bytes)
        return kBadPayload;
      return static_cast<size_t>(nrows * 4 + row_bytes);
    }
    if (nrows > kMaxPayload / (4 + row_bytes)) return kBadPayload;
    uint64_t total = nrows * (4 + row_bytes);
    if (total > kMaxPayload) return kBadPayload;
    return static_cast<size_t>(total);
  }
  if (cmd == "BGETROWS") {
    uint64_t nrows = 0;
    in >> key >> nrows;
    if (in.fail() || nrows > kMaxPayload / 4) return kBadPayload;
    return static_cast<size_t>(nrows * 4);
  }
  if (cmd != "BSET" && cmd != "BADD" && cmd != "BSTEP") return 0;
  uint64_t nbytes = 0;
  in >> key >> nbytes;
  if (in.fail() || nbytes > kMaxPayload) return kBadPayload;
  return static_cast<size_t>(nbytes);
}

// Optional trailing `<off> <total>` range on a B* command; defaults to
// the whole tensor (off 0, total = payload elements). The declared
// total is capped like the payload itself (kMaxPayload bytes of f32) —
// an unvalidated total would let one malformed command allocate
// int64-max floats and bad_alloc the service.
bool read_range(std::istringstream* in, size_t n_elems, size_t* off,
                size_t* total) {
  constexpr int64_t kMaxElems =
      static_cast<int64_t>(kMaxPayload / sizeof(float));
  *off = 0;
  *total = n_elems;
  int64_t o = -1, t = -1;
  if (*in >> o >> t) {
    if (o < 0 || t < 0 || t > kMaxElems ||
        static_cast<size_t>(o) + n_elems > static_cast<size_t>(t))
      return false;
    *off = static_cast<size_t>(o);
    *total = static_cast<size_t>(t);
  }
  return true;
}

// Handles one request. `payload` holds the request's raw bytes (B*
// commands); a BGET reply's bytes land in `reply_payload` and follow the
// returned header line on the wire.
std::string handle(const std::string& line, std::string_view payload,
                   std::string* reply_payload, ConnState* conn) {
  std::istringstream in(line);
  std::string cmd;
  in >> cmd;
  using namespace std::chrono;
  if (cmd == "PING") return "PONG";
  if (cmd == "FENCE") {
    std::string k;
    int64_t gen = -1;
    in >> k >> gen;
    if (k.empty() || gen < 0) return "ERR bad fence";
    std::lock_guard<std::mutex> l(g_store.mu);
    auto it = g_store.counters.find(k);
    int64_t cur = it == g_store.counters.end() ? 0 : it->second;
    // a would-be writer whose generation is already superseded must
    // learn it at bind time, not at its first rejected write
    if (cur > gen) return kFencedErr;
    conn->fence_key = k;
    conn->fence_gen = gen;
    return "OK";
  }
  if (cmd == "SET") {
    std::string k, v;
    in >> k;
    std::getline(in, v);
    if (!v.empty() && v[0] == ' ') v.erase(0, 1);
    std::lock_guard<std::mutex> l(g_store.mu);
    if (is_fenced_locked(*conn)) return kFencedErr;
    g_store.kv[k] = v;
    g_store.cv.notify_all();
    return "OK";
  }
  if (cmd == "GET") {
    std::string k;
    in >> k;
    std::lock_guard<std::mutex> l(g_store.mu);
    auto it = g_store.kv.find(k);
    return it == g_store.kv.end() ? "NONE" : ("VAL " + it->second);
  }
  if (cmd == "DEL") {
    std::string k;
    in >> k;
    std::lock_guard<std::mutex> l(g_store.mu);
    // deletes are mutations: a fenced zombie erasing live keys (or a
    // whole namespace below) corrupts state as surely as a write
    if (is_fenced_locked(*conn)) return kFencedErr;
    g_store.kv.erase(k);
    g_store.counters.erase(k);
    return "OK";
  }
  if (cmd == "DELNS") {
    // run-end cleanup: a long-lived endpoint daemon must not accumulate
    // a dead run's multi-hundred-MB tensors (ADVICE r3)
    std::string prefix;
    in >> prefix;
    if (prefix.empty()) return "ERR empty prefix";
    std::lock_guard<std::mutex> l(g_store.mu);
    if (is_fenced_locked(*conn)) return kFencedErr;
    size_t n = erase_prefix(&g_store.kv, prefix);
    n += erase_prefix(&g_store.counters, prefix);
    n += erase_prefix(&g_store.tensors, prefix);
    n += erase_prefix(&g_store.barrier_arrivals, prefix);
    n += erase_prefix(&g_store.barrier_generation, prefix);
    g_store.cv.notify_all();
    return "VAL " + std::to_string(n);
  }
  if (cmd == "INCR") {
    std::string k;
    int64_t d = 1;
    in >> k >> d;
    std::lock_guard<std::mutex> l(g_store.mu);
    if (d != 0 && is_fenced_locked(*conn)) return kFencedErr;
    int64_t v = (g_store.counters[k] += d);
    g_store.cv.notify_all();
    return "VAL " + std::to_string(v);
  }
  if (cmd == "WAITGE") {
    std::string k;
    int64_t n = 0, ms = 0;
    in >> k >> n >> ms;
    std::unique_lock<std::mutex> l(g_store.mu);
    bool ok = g_store.cv.wait_for(l, milliseconds(ms), [&] {
      return counter_of(k) >= n || g_store.shutting_down;
    });
    if (!ok || g_store.shutting_down) return "TIMEOUT";
    return "VAL " + std::to_string(counter_of(k));
  }
  if (cmd == "MINWAIT") {
    std::string prefix;
    int64_t n = 0, k = 0, ms = 0;
    in >> prefix >> n >> k >> ms;
    std::unique_lock<std::mutex> l(g_store.mu);
    int count = 0;
    bool ok = g_store.cv.wait_for(l, milliseconds(ms), [&] {
      int c = 0;
      int64_t m = prefix_min(prefix, &c);
      return (c >= k && m >= n) || g_store.shutting_down;
    });
    if (!ok || g_store.shutting_down) return "TIMEOUT";
    return "VAL " + std::to_string(prefix_min(prefix, &count));
  }
  if (cmd == "BARRIER") {
    std::string name;
    int64_t k = 0, ms = 0;
    in >> name >> k >> ms;
    std::unique_lock<std::mutex> l(g_store.mu);
    int64_t gen = g_store.barrier_generation[name];
    int64_t arrived = ++g_store.barrier_arrivals[name];
    if (arrived >= k) {
      g_store.barrier_arrivals[name] = 0;
      ++g_store.barrier_generation[name];
      g_store.cv.notify_all();
      return "OK";
    }
    bool ok = g_store.cv.wait_for(l, milliseconds(ms), [&] {
      return g_store.barrier_generation[name] != gen ||
             g_store.shutting_down;
    });
    if (ok && !g_store.shutting_down) return "OK";
    // Withdraw this party's arrival so a timeout doesn't poison the
    // barrier name: a later round must still need k live arrivals. Only
    // if the round we joined never completed (generation unchanged).
    if (g_store.barrier_generation[name] == gen &&
        g_store.barrier_arrivals[name] > 0) {
      --g_store.barrier_arrivals[name];
    }
    return "TIMEOUT";
  }
  if (cmd == "BSET") {
    std::string k, wire;
    size_t nbytes = 0;
    in >> k >> nbytes >> wire;
    const int64_t off_decl = declared_offset(&in);
    // a writer fenced mid-sequence aborts the sequence it opened
    // (abort_open_seq) so its readers are not wedged on odd parity
    if (is_fenced(*conn)) return abort_open_seq(conn, k, off_decl, kFencedErr);
    std::vector<float> vals;
    if (!decode_wire(payload, wire, &vals))
      return abort_open_seq(conn, k, off_decl, "ERR bad payload");
    size_t off, total;
    if (!read_range(&in, vals.size(), &off, &total))
      return abort_open_seq(conn, k, off_decl, "ERR bad range");
    std::shared_ptr<Tensor> t = find_tensor(k, /*create=*/true);
    std::lock_guard<std::mutex> l(t->mu);
    if (reject_fenced_under_tensor_lock(conn, k, t.get(), off_decl))
      return kFencedErr;
    SeqFrame seq(t.get(), off, conn, k);
    if (off == 0) {  // a (re)set starts at its first chunk
      t->data.assign(total, 0.f);
      t->slot1.clear();
      t->slot2.clear();
      t->pushes = 0;
      t->steps = 0;
    }
    if (t->data.size() != total) return seq.fail("ERR shape mismatch");
    std::copy(vals.begin(), vals.end(), t->data.begin() + off);
    seq.finish(off + vals.size() >= total);
    return "OK";
  }
  if (cmd == "BSTAT") {
    // tensor introspection: pushes, optimizer steps, element count,
    // slot residency — lets tests/tools verify PS-resident optimizer
    // state (shared adam: steps == total pushes across workers)
    std::string k;
    in >> k;
    std::shared_ptr<Tensor> t = find_tensor(k, /*create=*/false);
    if (!t) return "NONE";
    std::lock_guard<std::mutex> l(t->mu);
    return "VAL " + std::to_string(t->pushes) + " " +
           std::to_string(t->steps) + " " +
           std::to_string(t->data.size()) + " " +
           std::to_string(t->slot1.empty() ? 0 : 1) + " " +
           std::to_string(t->slot2.empty() ? 0 : 1);
  }
  if (cmd == "BGET") {
    std::string k, wire;
    in >> k >> wire;
    if (wire.empty()) wire = "f32";
    // optional trailing "v" (after the optional range) opts in to a
    // version field in the reply — old clients keep the old format
    int64_t o = -1, c = -1;
    bool have_range = static_cast<bool>(in >> o >> c);
    in.clear();
    std::string flag;
    bool want_ver = static_cast<bool>(in >> flag) && flag == "v";
    std::shared_ptr<Tensor> t = find_tensor(k, /*create=*/false);
    if (!t) return "NONE";
    {
      std::lock_guard<std::mutex> l(t->mu);
      size_t off = 0, count = t->data.size();
      if (have_range) {
        if (o < 0 || c < 0 ||
            static_cast<size_t>(o) + static_cast<size_t>(c) >
                t->data.size())
          return "ERR bad range";
        off = static_cast<size_t>(o);
        count = static_cast<size_t>(c);
      }
      if (!encode_wire(t->data.data() + off, count, wire, reply_payload))
        return "ERR bad wire dtype";
      std::string resp = "VAL " + std::to_string(reply_payload->size());
      if (want_ver)
        resp += " " + std::to_string(t->version * 2 +
                                     (t->open_writes > 0 ? 1 : 0));
      return resp;
    }
  }
  if (cmd == "BADD") {
    std::string k, wire;
    size_t nbytes = 0;
    in >> k >> nbytes >> wire;
    const int64_t off_decl = declared_offset(&in);
    if (is_fenced(*conn)) return abort_open_seq(conn, k, off_decl, kFencedErr);
    std::vector<float> delta;
    if (!decode_wire(payload, wire, &delta))
      return abort_open_seq(conn, k, off_decl, "ERR bad payload");
    size_t off, total;
    if (!read_range(&in, delta.size(), &off, &total))
      return abort_open_seq(conn, k, off_decl, "ERR bad range");
    std::shared_ptr<Tensor> t = find_tensor(k, /*create=*/true);
    std::lock_guard<std::mutex> l(t->mu);
    if (reject_fenced_under_tensor_lock(conn, k, t.get(), off_decl))
      return kFencedErr;
    SeqFrame seq(t.get(), off, conn, k);
    if (t->data.empty()) t->data.assign(total, 0.f);
    if (t->data.size() != total) return seq.fail("ERR shape mismatch");
    if (off == 0) ++t->pushes;  // one logical push counts once
    for (size_t i = 0; i < delta.size(); ++i)
      t->data[off + i] += delta[i];
    seq.finish(off + delta.size() >= total);
    return "VAL " + std::to_string(t->pushes);
  }
  if (cmd == "BSADD") {
    // row-sparse scatter-add: the sparse sibling of BADD. Payload is
    // <nrows> little-endian int32 row indices followed by <nrows> rows
    // of wire data (row_bytes wire bytes each); every listed row is
    // added into the stored [rows, cols] tensor at its index. The
    // optional <off> <total> range counts ROWS of the logical push;
    // fencing / sequence-abort semantics are exactly BADD's.
    std::string k, wire;
    uint64_t nrows = 0, row_bytes = 0;
    in >> k >> nrows >> row_bytes >> wire;
    const int64_t off_decl = declared_offset(&in);
    if (is_fenced(*conn)) return abort_open_seq(conn, k, off_decl, kFencedErr);
    // i8 (blockscale) blobs are not per-row divisible: row_bytes is
    // the whole blob length and cols derives from decoded elements
    const bool i8 = wire == "i8";
    const size_t itemsize = wire == "bf16" ? 2 : 4;
    if (row_bytes == 0 || (!i8 && row_bytes % itemsize))
      return abort_open_seq(conn, k, off_decl, "ERR bad row bytes");
    if (payload.size() < nrows * 4)
      return abort_open_seq(conn, k, off_decl, "ERR bad payload");
    std::vector<int32_t> idx(nrows);
    if (nrows) memcpy(idx.data(), payload.data(), nrows * 4);
    std::vector<float> rows;
    if (!decode_wire(payload.substr(nrows * 4), wire, &rows))
      return abort_open_seq(conn, k, off_decl, "ERR bad payload");
    // i8 derives ncols from the decoded blob: an empty blob (n=0) with
    // nrows>0 would make ncols 0 and the shape-check modulo below a
    // division by zero (SIGFPE kills the whole service) — reject it
    // like BGETROWS rejects ncols==0
    if (i8 ? (nrows == 0 || rows.empty() || rows.size() % nrows)
           : rows.size() != nrows * (row_bytes / itemsize))
      return abort_open_seq(conn, k, off_decl, "ERR bad payload");
    const size_t ncols =
        i8 ? rows.size() / nrows : static_cast<size_t>(row_bytes) / itemsize;
    size_t off, total;
    if (!read_range(&in, static_cast<size_t>(nrows), &off, &total))
      return abort_open_seq(conn, k, off_decl, "ERR bad range");
    std::shared_ptr<Tensor> t = find_tensor(k, /*create=*/false);
    // unlike BADD, absence is an error: a row set cannot size the
    // dense tensor it scatters into
    if (!t) return abort_open_seq(conn, k, off_decl, "ERR no tensor");
    std::lock_guard<std::mutex> l(t->mu);
    if (reject_fenced_under_tensor_lock(conn, k, t.get(), off_decl))
      return kFencedErr;
    SeqFrame seq(t.get(), off, conn, k);
    if (t->data.empty() || t->data.size() % ncols)
      return seq.fail("ERR shape mismatch");
    const size_t table_rows = t->data.size() / ncols;
    for (uint64_t r = 0; r < nrows; ++r)
      if (idx[r] < 0 || static_cast<size_t>(idx[r]) >= table_rows)
        return seq.fail("ERR bad row index");
    if (off == 0) ++t->pushes;  // one logical push counts once
    for (uint64_t r = 0; r < nrows; ++r) {
      float* dst = t->data.data() + static_cast<size_t>(idx[r]) * ncols;
      const float* src = rows.data() + r * ncols;
      for (size_t j = 0; j < ncols; ++j) dst[j] += src[j];
    }
    seq.finish(off + nrows >= total);
    return "VAL " + std::to_string(t->pushes);
  }
  if (cmd == "BGETROWS") {
    // fetch just the rows listed in the int32 request payload — the
    // read half of the row-sparse plane (proxy-cache refresh after a
    // sparse push, pull-ahead of a known next batch). The torn-read
    // version contract matches BGET's "v" flag.
    std::string k, wire;
    uint64_t nrows = 0, ncols = 0;
    in >> k >> nrows >> ncols >> wire;
    if (wire.empty()) wire = "f32";
    std::string flag;
    bool want_ver = static_cast<bool>(in >> flag) && flag == "v";
    // bound the reply like every other buffer (kMaxPayload of f32):
    // an unvalidated nrows*ncols would let one request allocate
    // hundreds of GB (or wrap size_t) and bad_alloc the service
    constexpr uint64_t kMaxElems = kMaxPayload / sizeof(float);
    if (ncols == 0 || ncols > kMaxElems || nrows > kMaxElems / ncols)
      return "ERR reply too large";
    if (payload.size() < nrows * 4) return "ERR bad payload";
    std::vector<int32_t> idx(nrows);
    if (nrows) memcpy(idx.data(), payload.data(), nrows * 4);
    std::shared_ptr<Tensor> t = find_tensor(k, /*create=*/false);
    if (!t) return "NONE";
    std::lock_guard<std::mutex> l(t->mu);
    if (t->data.size() % ncols) return "ERR shape mismatch";
    const size_t table_rows = t->data.size() / ncols;
    std::vector<float> rows(static_cast<size_t>(nrows) * ncols);
    for (uint64_t r = 0; r < nrows; ++r) {
      if (idx[r] < 0 || static_cast<size_t>(idx[r]) >= table_rows)
        return "ERR bad row index";
      memcpy(rows.data() + r * ncols,
             t->data.data() + static_cast<size_t>(idx[r]) * ncols,
             ncols * sizeof(float));
    }
    if (!encode_wire(rows.data(), rows.size(), wire, reply_payload))
      return "ERR bad wire dtype";
    std::string resp = "VAL " + std::to_string(reply_payload->size());
    if (want_ver)
      resp += " " + std::to_string(t->version * 2 +
                                   (t->open_writes > 0 ? 1 : 0));
    return resp;
  }
  if (cmd == "BSTEP") {
    std::string k, wire, rule;
    size_t nbytes = 0;
    int64_t t_in = 0;
    double p0 = 0, p1 = 0, p2 = 0, p3 = 0;
    in >> k >> nbytes >> wire >> rule >> t_in >> p0 >> p1 >> p2 >> p3;
    const int64_t off_decl = declared_offset(&in);
    if (is_fenced(*conn)) return abort_open_seq(conn, k, off_decl, kFencedErr);
    std::vector<float> grad;
    if (!decode_wire(payload, wire, &grad))
      return abort_open_seq(conn, k, off_decl, "ERR bad payload");
    size_t off, total;
    if (!read_range(&in, grad.size(), &off, &total))
      return abort_open_seq(conn, k, off_decl, "ERR bad range");
    std::shared_ptr<Tensor> t = find_tensor(k, /*create=*/false);
    if (!t) return "ERR no tensor";
    std::lock_guard<std::mutex> l(t->mu);
    if (reject_fenced_under_tensor_lock(conn, k, t.get(), off_decl))
      return kFencedErr;
    SeqFrame seq(t.get(), off, conn, k);
    if (t->data.size() != total) return seq.fail("ERR shape mismatch");
    int64_t step = t_in;
    if (off == 0 && step == 0) step = ++t->steps;
    if (step <= 0) return seq.fail("ERR bad step");
    float* w = t->data.data() + off;
    const float* g = grad.data();
    const size_t n = grad.size();
    const float lr = static_cast<float>(p0);
    if (rule == "sgd") {
      const float m = static_cast<float>(p1);
      if (m != 0.f) {
        if (t->slot1.empty()) t->slot1.assign(total, 0.f);
        if (t->slot1.size() != total) return seq.fail("ERR slot mismatch");
        float* vel = t->slot1.data() + off;
        for (size_t i = 0; i < n; ++i) {
          vel[i] = m * vel[i] + g[i];
          w[i] -= lr * vel[i];
        }
      } else {
        for (size_t i = 0; i < n; ++i) w[i] -= lr * g[i];
      }
    } else if (rule == "adam") {
      const float b1 = static_cast<float>(p1);
      const float b2 = static_cast<float>(p2);
      const float eps = static_cast<float>(p3);
      if (t->slot1.empty()) t->slot1.assign(total, 0.f);
      if (t->slot2.empty()) t->slot2.assign(total, 0.f);
      if (t->slot1.size() != total || t->slot2.size() != total)
        return seq.fail("ERR slot mismatch");
      float* m = t->slot1.data() + off;
      float* v = t->slot2.data() + off;
      const float c1 =
          1.f - static_cast<float>(std::pow((double)b1, (double)step));
      const float c2 =
          1.f - static_cast<float>(std::pow((double)b2, (double)step));
      for (size_t i = 0; i < n; ++i) {
        m[i] = b1 * m[i] + (1.f - b1) * g[i];
        v[i] = b2 * v[i] + (1.f - b2) * g[i] * g[i];
        const float mhat = m[i] / c1;
        const float vhat = v[i] / c2;
        w[i] -= lr * mhat / (std::sqrt(vhat) + eps);
      }
    } else if (rule == "adagrad") {
      const float eps = static_cast<float>(p1);
      const float init_acc = static_cast<float>(p2);
      if (t->slot2.empty()) t->slot2.assign(total, init_acc);
      if (t->slot2.size() != total) return seq.fail("ERR slot mismatch");
      float* acc = t->slot2.data() + off;
      for (size_t i = 0; i < n; ++i) {
        acc[i] += g[i] * g[i];
        w[i] -= lr * g[i] / (std::sqrt(acc[i]) + eps);
      }
    } else {
      return seq.fail("ERR unknown rule");
    }
    seq.finish(off + grad.size() >= total);
    return "VAL " + std::to_string(step);
  }
  if (cmd == "SHUTDOWN") {
    std::lock_guard<std::mutex> l(g_store.mu);
    g_store.shutting_down = true;
    g_store.cv.notify_all();
    return "OK";
  }
  return "ERR unknown command";
}

bool send_all(int fd, const char* data, size_t len) {
  while (len) {
    ssize_t n = send(fd, data, len, 0);
    if (n <= 0) return false;
    data += n;
    len -= static_cast<size_t>(n);
  }
  return true;
}

// Reads the next newline-terminated header line into *line; false on EOF.
bool read_line(int fd, std::string* buf, std::string* line) {
  char chunk[1 << 16];
  size_t pos;
  while ((pos = buf->find('\n')) == std::string::npos) {
    ssize_t n = recv(fd, chunk, sizeof(chunk), 0);
    if (n <= 0) return false;
    buf->append(chunk, n);
  }
  *line = buf->substr(0, pos);
  buf->erase(0, pos + 1);
  if (!line->empty() && line->back() == '\r') line->pop_back();
  return true;
}

void serve_conn(int fd) {
  // TCP_NODELAY on every accepted connection: replies are written as
  // two send() calls (header line, then payload) — under Nagle the
  // payload segment waits for the client's ACK of the header, and the
  // client's delayed ACK turns EVERY payload-bearing reply (BGET and
  // friends) into a ~40ms stall on loopback. The client side has set
  // this since PR 1; the accept side was the missing half.
  {
    int one = 1;
    setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  }
  std::string buf;
  char chunk[1 << 16];
  ConnState conn;
  // fires on EVERY exit path: a connection that dies mid-chunked-write
  // (worker crash = recv failure/EOF) aborts the sequences it opened
  // instead of wedging their readers on odd parity forever
  struct SeqAborter {
    ConnState* c;
    ~SeqAborter() { abort_conn_seqs(c); }
  } seq_aborter{&conn};
  // greeting + handshake: with a token configured every connection must
  // answer the nonce challenge before its first real command
  {
    std::string nonce = g_token.empty() ? "" : make_nonce();
    if (!g_token.empty() && nonce.empty()) {
      // no entropy source: refuse rather than issue a replayable nonce
      const char* err = "ERR no entropy for auth nonce\n";
      send_all(fd, err, strlen(err));
      close(fd);
      return;
    }
    std::string hello =
        "HELLO " + (g_token.empty() ? std::string("open") : nonce) + "\n";
    if (!send_all(fd, hello.data(), hello.size())) {
      close(fd);
      return;
    }
    if (!g_token.empty()) {
      std::string line;
      if (!read_line(fd, &buf, &line)) {
        close(fd);
        return;
      }
      std::istringstream in(line);
      std::string cmd, mac;
      in >> cmd >> mac;
      uint8_t want[32];
      hmac_sha256(g_token, nonce, want);
      if (cmd != "AUTH" || !constant_time_eq(mac, to_hex(want, 32))) {
        const char* err = "ERR auth failed\n";
        send_all(fd, err, strlen(err));
        close(fd);
        return;
      }
      const char* ok = "OK\n";
      if (!send_all(fd, ok, strlen(ok))) {
        close(fd);
        return;
      }
    }
  }
  while (!g_store.shutting_down) {
    std::string line;
    if (!read_line(fd, &buf, &line)) {
      close(fd);
      return;
    }
    // then that command's declared payload bytes
    size_t need = payload_size(line);
    if (need == kBadPayload) {
      // refuse oversized/garbage declarations instead of buffering
      // toward them (ADVICE r3); the stream is now unframed, so close
      const char* err = "ERR payload too large\n";
      send_all(fd, err, strlen(err));
      close(fd);
      return;
    }
    while (buf.size() < need) {
      ssize_t n = recv(fd, chunk, sizeof(chunk), 0);
      if (n <= 0) {
        close(fd);
        return;
      }
      buf.append(chunk, n);
    }
    // zero-copy payload view into the connection buffer (a 100 MB push
    // used to pay a full substr copy here); handle() is synchronous,
    // and the buffer is erased only after it returns
    std::string_view payload(buf.data(), need);
    std::string reply_payload;
    std::string resp = handle(line, payload, &reply_payload, &conn) + "\n";
    buf.erase(0, need);
    if (!send_all(fd, resp.data(), resp.size()) ||
        (!reply_payload.empty() &&
         !send_all(fd, reply_payload.data(), reply_payload.size()))) {
      close(fd);
      return;
    }
    if (g_store.shutting_down) {  // reply sent; exit promptly —
      close(fd);                  // accept() would otherwise block
      _exit(0);
    }
  }
  close(fd);
}

}  // namespace

int main(int argc, char** argv) {
  int port = argc > 1 ? atoi(argv[1]) : 14998;
  // Bind address: second arg; loopback unless the launcher asks for more
  // (multi-host runs pass 0.0.0.0 or the coordinator interface).
  const char* bind_addr = argc > 2 ? argv[2] : "127.0.0.1";
  // Shared secret from the environment (never argv: visible in ps);
  // multi-host launchers distribute it via the forwarded ENV set.
  const char* token = getenv("AUTODIST_COORD_TOKEN");
  if (token) g_token = token;
  int srv = socket(AF_INET, SOCK_STREAM, 0);
  int one = 1;
  setsockopt(srv, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = inet_addr(bind_addr);
  addr.sin_port = htons(port);
  if (bind(srv, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0) {
    perror("bind");
    return 1;
  }
  if (listen(srv, 128) != 0) {
    perror("listen");
    return 1;
  }
  fprintf(stderr, "coord_service listening on :%d (%s)\n", port,
          g_token.empty() ? "open" : "authenticated");
  fflush(stderr);
  std::vector<std::thread> threads;
  while (!g_store.shutting_down) {
    int fd = accept(srv, nullptr, nullptr);
    if (fd < 0) break;
    threads.emplace_back(serve_conn, fd);
  }
  close(srv);
  for (auto& t : threads)
    if (t.joinable()) t.detach();
  return 0;
}
