// framequeue — native latest-frame mailboxes + pacing for the serving loop.
//
// TPU-native replacement for the runtime role Ray's C++ core plays in the
// reference (plasma object store ferrying PIL frames between the asyncio
// server and per-GPU actor processes; reference: diffusert/server.py:108,
// videopipeline.py:11).  Here there are no actor processes — one Python
// process drives the chips — so the native layer is a set of wait-free
// per-stream single-producer/single-consumer mailboxes with
// latest-frame-wins semantics (the drop-older behavior of
// server.py:140-143), plus generation-time EMA pacing counters
// (server.py:96,113,134) kept out of the Python hot path.
//
// Concurrency: one writer thread per stream (network RX), one reader (the
// batcher).  Each mailbox is a 2-slot seqlock ring: the writer alternates
// slots and publishes with a release-store of the sequence; the reader
// retries on a torn read.  No locks, no allocation after create.

#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstring>
#include <new>

extern "C" {

struct Mailbox {
  std::atomic<uint64_t> seq{0};        // even = stable, odd = writing
  std::atomic<uint64_t> frame_id{0};   // latest published frame id
  uint64_t last_taken = 0;             // reader-private
  double ts[2] = {0.0, 0.0};
  uint8_t* slots[2] = {nullptr, nullptr};
};

struct FrameQueue {
  int n_streams = 0;
  size_t frame_bytes = 0;
  Mailbox* boxes = nullptr;
  uint8_t* arena = nullptr;
  // pacing / telemetry (reference EMA constants, server.py:96,113)
  std::atomic<double> ema_gen_time{0.4};
  std::atomic<double> last_gen_start{0.0};
  std::atomic<uint64_t> frames_in{0};
  std::atomic<uint64_t> frames_dropped{0};
  std::atomic<uint64_t> frames_out{0};
};

static double now_s() {
  using namespace std::chrono;
  return duration<double>(steady_clock::now().time_since_epoch()).count();
}

FrameQueue* fq_create(int n_streams, size_t frame_bytes) {
  auto* fq = new (std::nothrow) FrameQueue();
  if (!fq) return nullptr;
  fq->n_streams = n_streams;
  fq->frame_bytes = frame_bytes;
  fq->boxes = new (std::nothrow) Mailbox[n_streams];
  fq->arena = new (std::nothrow) uint8_t[(size_t)n_streams * 2 * frame_bytes];
  if (!fq->boxes || !fq->arena) {
    delete[] fq->boxes;
    delete[] fq->arena;
    delete fq;
    return nullptr;
  }
  for (int i = 0; i < n_streams; i++) {
    fq->boxes[i].slots[0] = fq->arena + ((size_t)i * 2 + 0) * frame_bytes;
    fq->boxes[i].slots[1] = fq->arena + ((size_t)i * 2 + 1) * frame_bytes;
  }
  return fq;
}

void fq_destroy(FrameQueue* fq) {
  if (!fq) return;
  delete[] fq->boxes;
  delete[] fq->arena;
  delete fq;
}

// Producer: publish the latest frame for `stream` (overwrites any unread
// frame — latest-frame-wins).  Returns the assigned frame id.
uint64_t fq_put(FrameQueue* fq, int stream, const uint8_t* data, size_t len) {
  if (stream < 0 || stream >= fq->n_streams || len > fq->frame_bytes) return 0;
  Mailbox& mb = fq->boxes[stream];
  uint64_t s = mb.seq.load(std::memory_order_relaxed);
  int slot = (int)((s >> 1) & 1) ^ 1;  // write the non-current slot
  mb.seq.store(s + 1, std::memory_order_release);  // mark writing (odd)
  std::memcpy(mb.slots[slot], data, len);
  mb.ts[slot] = now_s();
  uint64_t id = fq->frames_in.fetch_add(1, std::memory_order_relaxed) + 1;
  uint64_t prev = mb.frame_id.exchange(id, std::memory_order_relaxed);
  if (prev > mb.last_taken) {
    fq->frames_dropped.fetch_add(1, std::memory_order_relaxed);
  }
  mb.seq.store(s + 2, std::memory_order_release);  // publish (even, new slot)
  return id;
}

// Consumer: copy out the latest frame if it is newer than the last taken
// one.  Returns the frame id (0 = nothing new).
uint64_t fq_take(FrameQueue* fq, int stream, uint8_t* out, size_t len,
                 double* ts_out) {
  if (stream < 0 || stream >= fq->n_streams || len > fq->frame_bytes) return 0;
  Mailbox& mb = fq->boxes[stream];
  uint64_t id = mb.frame_id.load(std::memory_order_relaxed);
  if (id == 0 || id == mb.last_taken) return 0;
  for (;;) {
    uint64_t s0 = mb.seq.load(std::memory_order_acquire);
    if (s0 & 1) continue;  // writer mid-publish
    int slot = (int)((s0 >> 1) & 1);
    std::memcpy(out, mb.slots[slot], len);
    double ts = mb.ts[slot];
    id = mb.frame_id.load(std::memory_order_relaxed);
    uint64_t s1 = mb.seq.load(std::memory_order_acquire);
    if (s0 == s1) {  // untorn
      mb.last_taken = id;
      if (ts_out) *ts_out = ts;
      fq->frames_out.fetch_add(1, std::memory_order_relaxed);
      return id;
    }
  }
}

// True when a fresh (untaken) frame is waiting on `stream`.
int fq_has_fresh(FrameQueue* fq, int stream) {
  if (stream < 0 || stream >= fq->n_streams) return 0;
  Mailbox& mb = fq->boxes[stream];
  uint64_t id = mb.frame_id.load(std::memory_order_relaxed);
  return id != 0 && id != mb.last_taken;
}

// ------- pacing (EMA of generation seconds; reference server.py:113,134)

void fq_record_gen(FrameQueue* fq, double seconds) {
  double e = fq->ema_gen_time.load(std::memory_order_relaxed);
  fq->ema_gen_time.store(0.95 * e + 0.05 * seconds, std::memory_order_relaxed);
}

void fq_mark_gen_start(FrameQueue* fq) {
  fq->last_gen_start.store(now_s(), std::memory_order_relaxed);
}

// Reference admission gate: dispatch only if enough time has passed since
// the last generation start, scaled by sessions per executor
// (server.py:134).
int fq_pacing_ok(FrameQueue* fq, int sessions, int executors) {
  double e = fq->ema_gen_time.load(std::memory_order_relaxed);
  double last = fq->last_gen_start.load(std::memory_order_relaxed);
  if (executors < 1) executors = 1;
  return (now_s() - last) >= e * (double)sessions / (double)executors ? 1 : 0;
}

double fq_ema(FrameQueue* fq) {
  return fq->ema_gen_time.load(std::memory_order_relaxed);
}

uint64_t fq_stat(FrameQueue* fq, int which) {
  switch (which) {
    case 0: return fq->frames_in.load(std::memory_order_relaxed);
    case 1: return fq->frames_out.load(std::memory_order_relaxed);
    case 2: return fq->frames_dropped.load(std::memory_order_relaxed);
  }
  return 0;
}

}  // extern "C"
