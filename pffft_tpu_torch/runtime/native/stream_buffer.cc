// The stream framer's ring buffer: arbitrary-size chunks in, overlapping
// [frames, frame_len] float batches out (stride hop, frame_len - hop
// samples of overlap carried), the block-cutting loop of the original
// library's pffastconv_apply hoisted out of the device path so that the
// device sees fixed shapes.
//
// The port's own copy of the JAX package's ring buffer, with the symbols
// prefixed pftt_.  Storage is 64-byte aligned.  One producer and one
// consumer per ring; rings are independent.

#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

struct Ring {
  float* buf;         // aligned storage of capacity floats
  uint64_t capacity;  // a power of two
  uint64_t head;      // absolute write position (monotonic)
  uint64_t tail;      // absolute read position (monotonic; frames start here)
};

uint64_t next_pow2(uint64_t n) {
  uint64_t p = 1;
  while (p < n) p <<= 1;
  return p;
}

}  // namespace

extern "C" {

// A ring of at least capacity_hint samples (at least 1024, rounded up to a
// power of two); NULL if the allocation fails.
void* pftt_ring_new(uint64_t capacity_hint) {
  Ring* r = (Ring*)std::malloc(sizeof(Ring));
  if (!r) return nullptr;
  r->capacity = next_pow2(capacity_hint < 1024 ? 1024 : capacity_hint);
  void* p = nullptr;
  if (posix_memalign(&p, 64, r->capacity * sizeof(float)) != 0) {
    std::free(r);
    return nullptr;
  }
  r->buf = (float*)p;
  r->head = 0;
  r->tail = 0;
  return r;
}

void pftt_ring_free(void* ring) {
  if (!ring) return;
  Ring* r = (Ring*)ring;
  std::free(r->buf);
  std::free(r);
}

uint64_t pftt_ring_size(void* ring) {
  Ring* r = (Ring*)ring;
  return r->head - r->tail;
}

uint64_t pftt_ring_capacity(void* ring) { return ((Ring*)ring)->capacity; }

// Append n samples; returns the samples written (fewer than n if full).
uint64_t pftt_ring_write(void* ring, const float* data, uint64_t n) {
  Ring* r = (Ring*)ring;
  const uint64_t free_space = r->capacity - (r->head - r->tail);
  if (n > free_space) n = free_space;
  const uint64_t mask = r->capacity - 1;
  const uint64_t pos = r->head & mask;
  const uint64_t first = (n < r->capacity - pos) ? n : r->capacity - pos;
  std::memcpy(r->buf + pos, data, first * sizeof(float));
  if (n > first) std::memcpy(r->buf, data + first, (n - first) * sizeof(float));
  r->head += n;
  return n;
}

// Emit up to max_frames frames of frame_len samples advancing by hop
// (hop <= frame_len) into out (room for max_frames * frame_len floats).
// Returns the frames emitted; consumes frames * hop samples.
uint64_t pftt_ring_read_frames(void* ring, float* out, uint64_t frame_len,
                               uint64_t hop, uint64_t max_frames) {
  if (hop == 0 || frame_len == 0 || hop > frame_len) return 0;
  Ring* r = (Ring*)ring;
  const uint64_t mask = r->capacity - 1;
  uint64_t frames = 0;
  while (frames < max_frames && (r->head - r->tail) >= frame_len) {
    const uint64_t start = r->tail & mask;
    const uint64_t first =
        (frame_len < r->capacity - start) ? frame_len : r->capacity - start;
    std::memcpy(out, r->buf + start, first * sizeof(float));
    if (frame_len > first)
      std::memcpy(out + first, r->buf, (frame_len - first) * sizeof(float));
    out += frame_len;
    r->tail += hop;
    ++frames;
  }
  return frames;
}

// Drain up to frame_len remaining samples into one frame, zero-padded.
// Returns the samples placed (0 if the ring is empty).
uint64_t pftt_ring_flush_frame(void* ring, float* out, uint64_t frame_len) {
  Ring* r = (Ring*)ring;
  const uint64_t avail = r->head - r->tail;
  if (avail == 0) return 0;
  const uint64_t n = avail < frame_len ? avail : frame_len;
  const uint64_t mask = r->capacity - 1;
  const uint64_t start = r->tail & mask;
  const uint64_t first = (n < r->capacity - start) ? n : r->capacity - start;
  std::memcpy(out, r->buf + start, first * sizeof(float));
  if (n > first) std::memcpy(out + first, r->buf, (n - first) * sizeof(float));
  if (n < frame_len) std::memset(out + n, 0, (frame_len - n) * sizeof(float));
  r->tail += n;
  return n;
}

}  // extern "C"
