// Native dataflow layer: PNG frame decoding, a prefetching frame loader
// with a recycling slot allocator, and the sequence scheduler that
// interleaves frames and event packets.
//
// The reference delegates this whole layer to the external Rock/orogen task
// (SURVEY §0 L7: "the dataflow loop, buffering of events/images, and wiring
// of L2-L6"); this framework ships it natively. Rationale: frame decode +
// event packetization are the serial host work that must overlap the device
// compute — a Python-thread loader is throttled by the GIL during zlib
// inflate + unfiltering, while these workers run free (ctypes releases the
// GIL for the blocking next() call).
//
// Components:
//  * png_decode        — standalone PNG decoder (zlib inflate + scanline
//                        unfiltering; same subset as slam_eds_tpu/io/
//                        image_rw.py: gray 8/16-bit, RGB(A) 8-bit,
//                        non-interlaced, all five filters).
//  * FrameLoader       — N worker threads decode dataset frames ahead of the
//                        consumer, in order, into a fixed pool of recycled
//                        slots (the memory-management piece: buffers are
//                        acquired/released, never re-malloc'd in steady
//                        state).
//  * SequenceScheduler — deterministic merge of the frame stream and the
//                        event stream into typed work items (FRAME k |
//                        EVENTS packet), the same interleaving the Python
//                        runner loop performs (slam_eds_tpu/runner.py):
//                        after frame k, events are sliced at t_{k+1} into
//                        packets of at most `cap` events; packets thinner
//                        than `min_events` are dropped (too sparse to
//                        rasterize a usable event frame).

#include <zlib.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

// from event_runtime.cpp (same shared library)
extern "C" {
void png_unfilter_rows(uint8_t* rows, const uint8_t* ftypes, int64_t n_rows,
                       int64_t stride, int64_t bpp);
int64_t event_ring_pop_until(void* ring, double t_end, int64_t capacity,
                             float* xs, float* ys, double* ts, float* ps,
                             double* median_t);
int64_t event_ring_push(void* ring, const float* xs, const float* ys,
                        const double* ts, const float* ps, int64_t n);
int64_t event_ring_size(void* ring);
int64_t event_ring_free(void* ring);
int64_t event_file_read(void* reader, float* xs, float* ys, double* ts,
                        float* ps, int64_t max_n);
}

namespace {

struct DecodedFrame {
  std::vector<uint8_t> pixels;  // native-endian, row-major, channel-packed
  int32_t width = 0;
  int32_t height = 0;
  int32_t channels = 0;
  int32_t depth = 0;  // 8 or 16 (bits per channel)
  bool ok = false;
};

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

// Decode one PNG file into `out` (pixels resized as needed). Returns false on
// any parse/inflate error. Matches io/image_rw.read_png's subset; 16-bit
// samples are byte-swapped to native little-endian so numpy can view them
// directly as uint16.
bool png_decode_file(const char* path, DecodedFrame* out) {
  out->ok = false;
  std::FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  const long fsize = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (fsize < 45) {  // signature + IHDR + IEND minimum
    std::fclose(f);
    return false;
  }
  std::vector<uint8_t> data(static_cast<size_t>(fsize));
  const size_t rd = std::fread(data.data(), 1, data.size(), f);
  std::fclose(f);
  if (rd != data.size()) return false;

  static const uint8_t kSig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
  if (std::memcmp(data.data(), kSig, 8) != 0) return false;

  uint32_t w = 0, h = 0;
  int depth = 0, color = 0, interlace = 0;
  std::vector<uint8_t> idat;
  size_t pos = 8;
  while (pos + 12 <= data.size()) {
    const uint32_t n = be32(&data[pos]);
    if (pos + 12 + n > data.size()) return false;
    const uint8_t* tag = &data[pos + 4];
    const uint8_t* payload = &data[pos + 8];
    if (!std::memcmp(tag, "IHDR", 4) && n >= 13) {
      w = be32(payload);
      h = be32(payload + 4);
      depth = payload[8];
      color = payload[9];
      interlace = payload[12];
    } else if (!std::memcmp(tag, "IDAT", 4)) {
      idat.insert(idat.end(), payload, payload + n);
    } else if (!std::memcmp(tag, "IEND", 4)) {
      break;
    }
    pos += 12 + n;
  }
  if (w == 0 || h == 0 || interlace != 0) return false;
  if (depth != 8 && depth != 16) return false;
  // Sanity-bound dimensions before allocating: a corrupt/malicious IHDR
  // with huge w/h would overflow the int64 raw size or throw bad_alloc
  // inside a FrameLoader worker thread (uncaught -> std::terminate).
  // 100 megapixels is far beyond any event-camera rig.
  if (int64_t(w) * int64_t(h) > int64_t(100) * 1000 * 1000) return false;
  int channels;
  switch (color) {
    case 0: channels = 1; break;
    case 2: channels = 3; break;
    case 4: channels = 2; break;
    case 6: channels = 4; break;
    default: return false;  // palette unsupported (as in image_rw)
  }

  const int64_t stride = int64_t(w) * channels * (depth / 8);
  const int64_t raw_size = int64_t(h) * (1 + stride);
  std::vector<uint8_t> raw(static_cast<size_t>(raw_size));
  uLongf dst_len = static_cast<uLongf>(raw_size);
  if (uncompress(raw.data(), &dst_len, idat.data(),
                 static_cast<uLong>(idat.size())) != Z_OK ||
      dst_len != static_cast<uLongf>(raw_size)) {
    return false;
  }

  // split filter bytes from scanlines, then unfilter in place
  std::vector<uint8_t> ftypes(h);
  out->pixels.resize(static_cast<size_t>(int64_t(h) * stride));
  for (uint32_t r = 0; r < h; ++r) {
    const uint8_t* src = raw.data() + int64_t(r) * (1 + stride);
    ftypes[r] = src[0];
    if (ftypes[r] > 4) return false;
    std::memcpy(out->pixels.data() + int64_t(r) * stride, src + 1,
                static_cast<size_t>(stride));
  }
  png_unfilter_rows(out->pixels.data(), ftypes.data(), h, stride,
                    channels * (depth / 8));

  if (depth == 16) {  // big-endian on the wire -> native uint16
    uint8_t* p = out->pixels.data();
    const int64_t n16 = int64_t(h) * w * channels;
    for (int64_t i = 0; i < n16; ++i) std::swap(p[2 * i], p[2 * i + 1]);
  }
  out->width = static_cast<int32_t>(w);
  out->height = static_cast<int32_t>(h);
  out->channels = channels;
  out->depth = depth;
  out->ok = true;
  return true;
}

// ---------------------------------------------------------------------------
// FrameLoader: in-order prefetching decoder over a fixed slot pool.
//
// Slot lifecycle (the allocator): a slot's pixel vector is allocated on first
// use and *recycled* afterwards — release() only flips state, so in steady
// state decode runs with zero heap churn. Workers claim frame indices from an
// atomic counter; frame k lands in slot k % depth; claiming waits until the
// consumer has released that slot (bounded prefetch = backpressure).
class FrameLoader {
 public:
  FrameLoader(std::vector<std::string> paths, int n_threads, int depth)
      : paths_(std::move(paths)),
        slots_(static_cast<size_t>(depth)),
        next_claim_(0),
        stop_(false) {
    for (auto& s : slots_) s.state = kFree;
    // threads must not exceed slots: with more workers than slots, claims
    // k and k+depth can wait on the SAME slot and the later claim can win
    // the free slot, deadlocking in-order delivery. With threads <= depth
    // every in-flight claim maps to a distinct slot (a blocked claim c
    // implies consumed <= c-depth, which blocks all claims past c before
    // they can wrap around).
    n_threads = std::max(1, std::min<int>(n_threads,
                                          static_cast<int>(slots_.size())));
    for (int i = 0; i < n_threads; ++i) {
      workers_.emplace_back([this] { this->work(); });
    }
  }

  ~FrameLoader() {
    {
      std::unique_lock<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_free_.notify_all();
    cv_ready_.notify_all();
    for (auto& t : workers_) t.join();
  }

  // Block until frame `consumed_` is decoded; fill metadata. Returns 1 on a
  // ready frame, 0 when the sequence is exhausted, -1 on decode failure.
  int next_meta(int32_t* w, int32_t* h, int32_t* c, int32_t* d) {
    if (consumed_ >= static_cast<int64_t>(paths_.size())) return 0;
    Slot& s = slots_[static_cast<size_t>(consumed_ % depth())];
    std::unique_lock<std::mutex> lk(mu_);
    cv_ready_.wait(lk, [&] {
      return stop_ || (s.state == kReady && s.index == consumed_);
    });
    if (stop_) return 0;
    if (!s.frame.ok) return -1;
    *w = s.frame.width;
    *h = s.frame.height;
    *c = s.frame.channels;
    *d = s.frame.depth;
    return 1;
  }

  // Copy the current frame's pixels out, free its slot, advance.
  int64_t take(uint8_t* dst, int64_t dst_bytes) {
    Slot& s = slots_[static_cast<size_t>(consumed_ % depth())];
    const int64_t n =
        std::min<int64_t>(dst_bytes, static_cast<int64_t>(s.frame.pixels.size()));
    if (dst && n > 0) std::memcpy(dst, s.frame.pixels.data(), n);
    {
      std::unique_lock<std::mutex> lk(mu_);
      s.state = kFree;
      ++consumed_;
    }
    cv_free_.notify_all();
    return n;
  }

 private:
  enum SlotState { kFree, kDecoding, kReady };
  struct Slot {
    DecodedFrame frame;
    SlotState state = kFree;
    int64_t index = -1;
  };

  int64_t depth() const { return static_cast<int64_t>(slots_.size()); }

  void work() {
    for (;;) {
      const int64_t k = next_claim_.fetch_add(1);
      if (k >= static_cast<int64_t>(paths_.size())) return;
      Slot& s = slots_[static_cast<size_t>(k % depth())];
      {
        std::unique_lock<std::mutex> lk(mu_);
        // The slot is tied to its in-order owner: claim k may take slot
        // k%depth only once every frame before k-depth has been consumed
        // (k - consumed_ < depth). Without the second clause a worker
        // holding claim k+depth could win the freed slot that blocked
        // claim k was waiting on (it churned through claims
        // k+1..k+depth-1 while claim k's worker was slow to reschedule
        // after notify_all), decode frame k+depth into it, and deadlock
        // the consumer (waiting for index==k) against claim k's worker
        // (waiting for kFree).
        cv_free_.wait(lk, [&] {
          return stop_ || (s.state == kFree && k - consumed_ < depth());
        });
        if (stop_) return;
        s.state = kDecoding;
        s.index = k;
      }
      try {
        png_decode_file(paths_[static_cast<size_t>(k)].c_str(), &s.frame);
      } catch (...) {
        // bad_alloc or any other decode-side throw must surface as a
        // decode failure (next_meta -> -1), not std::terminate the process
        s.frame.ok = false;
      }
      {
        std::unique_lock<std::mutex> lk(mu_);
        s.state = kReady;
      }
      cv_ready_.notify_all();
    }
  }

  std::vector<std::string> paths_;
  std::vector<Slot> slots_;
  std::vector<std::thread> workers_;
  std::atomic<int64_t> next_claim_;
  int64_t consumed_ = 0;
  bool stop_;
  std::mutex mu_;
  std::condition_variable cv_free_, cv_ready_;
};

// ---------------------------------------------------------------------------
// SequenceScheduler: the dataflow loop as a state machine.
//
// Mirrors runner.py's interleave exactly: emit FRAME k, then slice all events
// with t < t_{k+1} into packets of at most `cap`, dropping packets with fewer
// than `min_events` (too thin to rasterize), then FRAME k+1, ... The event
// ring is topped up from the reader between pops so ring capacity bounds
// memory, not file size.
class SequenceScheduler {
 public:
  SequenceScheduler(void* ring, void* reader, const double* times, int64_t n,
                    int64_t cap, int64_t min_events)
      : ring_(ring),
        reader_(reader),
        times_(times, times + n),
        cap_(cap),
        min_events_(min_events) {}

  // Returns 0 = done, 1 = frame (frame_idx filled), 2 = event packet
  // (arrays of length cap_ filled, n_valid / median_t set).
  int next(float* xs, float* ys, double* ts, float* ps, int64_t* n_valid,
           double* median_t, int64_t* frame_idx) {
    for (;;) {
      if (phase_ == kFrame) {
        if (k_ >= static_cast<int64_t>(times_.size())) return 0;
        *frame_idx = k_;
        phase_ = kEvents;
        return 1;
      }
      // events between frame k_ and k_+1
      if (k_ + 1 >= static_cast<int64_t>(times_.size())) {
        ++k_;
        phase_ = kFrame;
        continue;  // -> done
      }
      pump();
      const double t_next = times_[static_cast<size_t>(k_ + 1)];
      const int64_t n = event_ring_pop_until(ring_, t_next, cap_, xs, ys, ts,
                                             ps, median_t);
      const bool drained = n < cap_;
      if (drained) {
        ++k_;
        phase_ = kFrame;
      }
      if (n >= min_events_) {
        *n_valid = n;
        return 2;
      }
      // thin packet: drop it and continue (next frame or another pop)
    }
  }

 private:
  // Keep the ring topped up without unbounded growth: read while the ring
  // has room and the file still has data. event_ring_push may accept only
  // part of a chunk (ring full); the remainder is carried over to the next
  // pump instead of being dropped.
  void pump() {
    if (!reader_ || eof_) return;
    constexpr int64_t kChunk = 1 << 16;
    while (event_ring_size(ring_) < (cap_ << 4)) {
      if (pend_n_ == 0) {
        pend_n_ = event_file_read(reader_, px_.data(), py_.data(),
                                  pt_.data(), pp_.data(), kChunk);
        pend_at_ = 0;
        if (pend_n_ == 0) {
          eof_ = true;
          return;
        }
      }
      // never offer more than the ring's free space: the ring counts any
      // rejected overflow as dropped (a real sensor would lose it), but a
      // file reader can simply wait
      const int64_t room = event_ring_free(ring_);
      if (room <= 0) return;
      const int64_t m = std::min(room, pend_n_);
      const int64_t pushed = event_ring_push(
          ring_, px_.data() + pend_at_, py_.data() + pend_at_,
          pt_.data() + pend_at_, pp_.data() + pend_at_, m);
      pend_at_ += pushed;
      pend_n_ -= pushed;
      if (pend_n_ > 0) return;  // ring full: keep the rest for next pump
    }
  }

  enum Phase { kFrame, kEvents };
  void* ring_;
  void* reader_;
  std::vector<double> times_;
  const int64_t cap_;
  const int64_t min_events_;
  int64_t k_ = 0;
  Phase phase_ = kFrame;
  bool eof_ = false;
  int64_t pend_n_ = 0;   // carried-over events the ring had no room for
  int64_t pend_at_ = 0;
  std::vector<float> px_ = std::vector<float>(1 << 16),
                     py_ = std::vector<float>(1 << 16),
                     pp_ = std::vector<float>(1 << 16);
  std::vector<double> pt_ = std::vector<double>(1 << 16);
};

}  // namespace

extern "C" {

// --- standalone PNG decode (two-call protocol: probe then take) -----------

void* png_open(const char* path) {
  auto* f = new DecodedFrame();
  if (!png_decode_file(path, f)) {
    delete f;
    return nullptr;
  }
  return f;
}

void png_meta(void* h, int32_t* w, int32_t* hh, int32_t* c, int32_t* d) {
  auto* f = static_cast<DecodedFrame*>(h);
  *w = f->width;
  *hh = f->height;
  *c = f->channels;
  *d = f->depth;
}

int64_t png_take(void* h, uint8_t* dst, int64_t dst_bytes) {
  auto* f = static_cast<DecodedFrame*>(h);
  const int64_t n =
      std::min<int64_t>(dst_bytes, static_cast<int64_t>(f->pixels.size()));
  if (dst && n > 0) std::memcpy(dst, f->pixels.data(), n);
  delete f;
  return n;
}

// --- frame loader ----------------------------------------------------------

// paths: '\n'-joined file names. n_threads decode workers, depth slots.
void* frame_loader_create(const char* paths, int32_t n_threads,
                          int32_t depth) {
  std::vector<std::string> list;
  const char* p = paths;
  while (*p) {
    const char* nl = std::strchr(p, '\n');
    if (!nl) {
      list.emplace_back(p);
      break;
    }
    list.emplace_back(p, nl - p);
    p = nl + 1;
  }
  return new FrameLoader(std::move(list), n_threads, std::max(2, depth));
}

void frame_loader_destroy(void* h) { delete static_cast<FrameLoader*>(h); }

int32_t frame_loader_next_meta(void* h, int32_t* w, int32_t* hh, int32_t* c,
                               int32_t* d) {
  return static_cast<FrameLoader*>(h)->next_meta(w, hh, c, d);
}

int64_t frame_loader_take(void* h, uint8_t* dst, int64_t dst_bytes) {
  return static_cast<FrameLoader*>(h)->take(dst, dst_bytes);
}

// --- sequence scheduler ----------------------------------------------------

void* sched_create(void* ring, void* reader, const double* frame_times,
                   int64_t n_frames, int64_t cap, int64_t min_events) {
  return new SequenceScheduler(ring, reader, frame_times, n_frames, cap,
                               min_events);
}

void sched_destroy(void* h) { delete static_cast<SequenceScheduler*>(h); }

int32_t sched_next(void* h, float* xs, float* ys, double* ts, float* ps,
                   int64_t* n_valid, double* median_t, int64_t* frame_idx) {
  return static_cast<SequenceScheduler*>(h)->next(xs, ys, ts, ps, n_valid,
                                                  median_t, frame_idx);
}

}  // extern "C"
