#include <cstdlib>
// Native entropy decoder for the .dwt bitstream.
//
// Decode-side bit parsing is inherently serial (every codeword's position
// depends on all previous ones), so the TPU framework runs it as a native
// host stage: this C++ parser emits linearized wavelet coefficients, and
// the inverse pipeline (bias, Hilbert scatter, inverse lifting, color)
// runs as jitted JAX ops on the TPU (dwt_tpu/codec/decoder.py).
//
// Behavioral contract mirrors the reference decoder exactly
// (decode.c:67-243, rle.h, vli.h, bits.h), including graceful EOF at any
// point (truncated streams), sticky error propagation, reduced-resolution
// bail (decode.c:213-214) and per-(channel, level) missing-plane counts.
// Unlike the reference's one-bit-at-a-time FILE* stack, this parser uses a
// 64-bit accumulator refilled straight from the mapped buffer; a run
// fast-path consumes pending zero-runs without per-bit work.
//
// Built as a shared library; called from Python via ctypes
// (dwt_tpu/runtime/native.py).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#ifdef __BMI2__
#include <immintrin.h>
#endif

namespace {

constexpr int kSgnBit = 31;
constexpr int kSigBit = 30;
constexpr int kRefBit = 29;
constexpr uint32_t kSgnMask = 1u << kSgnBit;
constexpr uint32_t kSigMask = 1u << kSigBit;
constexpr uint32_t kRefMask = 1u << kRefBit;

struct BitReader {
  const uint8_t* data;
  int64_t nbytes;
  int64_t pos = 0;     // next byte to load
  uint64_t acc = 0;    // LSB-first bit accumulator
  int navail = 0;      // bits in acc
  bool fail = false;

  void refill() {
    // Fast path: one unaligned 64-bit load tops the accumulator up to
    // >= 57 bits (only whole bytes that fit are consumed).
    if (navail <= 56 && pos + 8 <= nbytes) {
      uint64_t w;
      std::memcpy(&w, data + pos, 8);
      int take = (64 - navail) >> 3;
      // Only whole bytes that fit are consumed; mask the rest off so the
      // bits >= navail of acc stay zero (the next refill ORs over them).
      if (take < 8) w &= (1ull << (take << 3)) - 1;
      acc |= w << navail;
      pos += take;
      navail += take << 3;
      return;
    }
    while (navail <= 56 && pos < nbytes) {
      acc |= static_cast<uint64_t>(data[pos++]) << navail;
      navail += 8;
    }
  }

  // Returns 0/1, or -1 on EOF (sticky).
  inline int get_bit() {
    if (fail) return -1;
    if (navail == 0) {
      refill();
      if (navail == 0) {
        fail = true;
        return -1;
      }
    }
    int b = static_cast<int>(acc & 1);
    acc >>= 1;
    navail -= 1;
    return b;
  }

  // LSB-first n-bit read; -1 on EOF.
  inline int64_t read_bits(int n) {
    if (fail) return -1;
    if (navail < n) refill();
    if (navail >= n) {
      int64_t v = static_cast<int64_t>(acc & ((n == 64) ? ~0ull : ((1ull << n) - 1)));
      acc >>= n;
      navail -= n;
      return v;
    }
    // Slow path across the tail.
    int64_t v = 0;
    for (int i = 0; i < n; ++i) {
      int b = get_bit();
      if (b < 0) return -1;
      v |= static_cast<int64_t>(b) << i;
    }
    return v;
  }
};

struct VliReader {
  BitReader* bits;
  int order = 0;

  // Adaptive Rice/Elias get (vli.h:86-101): count prefix zeros with the
  // order escalating per zero, then `order` raw bits; order decays by 2.
  // The prefix zeros are consumed in bulk with ctz on the 64-bit
  // accumulator instead of bit-by-bit: a run of z zeros at entry order s
  // contributes sum += (2^z - 1) << s and advances the order by z.
  // Valid streams never push the order past ~33 (run lengths < 2^31);
  // beyond 48 the stream is corrupt and decoding stops (the bit-serial
  // reference would shift-overflow there — hard-stopping is the safe
  // behavioral superset, and matches its EOF handling).
  inline int64_t get() {
    BitReader* b = bits;
    if (b->fail) return -1;
    int64_t sum = 0;
    for (;;) {
      if (b->navail == 0) {
        b->refill();
        if (b->navail == 0) {
          b->fail = true;
          return -1;
        }
      }
      if (b->acc != 0) {  // terminator within the buffered bits
        int z = __builtin_ctzll(b->acc);
        if (order + z > 48) return -1;
        sum += ((1ll << z) - 1) << order;
        order += z;
        b->acc >>= z + 1;
        b->navail -= z + 1;
        break;
      }
      // All buffered bits are prefix zeros.
      int n = b->navail;
      if (order + n > 48) return -1;
      sum += ((1ll << n) - 1) << order;
      order += n;
      b->acc = 0;
      b->navail = 0;
    }
    int64_t v = bits->read_bits(order);
    if (v < 0) return -1;
    order -= 2;
    if (order < 0) order = 0;
    return v + sum;
  }
};

struct RleReader {
  VliReader* vli;
  int64_t cnt = 0;  // pending zeros; <0 = sticky error

  // Next significance bit (rle.h:66-77).
  inline int get_rle() {
    if (cnt < 0) return -1;
    if (!cnt) {
      cnt = vli->get();
      if (cnt < 0) return -1;
      return !cnt;
    }
    return cnt-- == 1;
  }

  // Raw bit; any pending run must end exactly here (rle.h:79-103).
  inline int get_bit() {
    if (cnt < 0) return -1;
    if (cnt > 0) {
      int r = get_rle();
      if (r < 0) return -1;
      if (r != 1) return -1;
    }
    return vli->bits->get_bit();
  }
};

// Per-(channel, chunk) significance bookkeeping.  The reference re-scans
// every coefficient on every plane, checking state flags per position
// (decode.c:73-99, O(num * planes) branchy work).  We instead keep the
// insignificant / significant position sets as *bitmasks* and work a word
// (64 positions) at a time: zero runs jump via popcount, the newly
// significant position inside a word is found with pdep+ctz select, and a
// whole word of refinement bits deposits onto the significant positions
// with one pdep.  Each plane costs O(words) + O(symbols actually coded) —
// no per-plane list rebuilds (a sorted-vector variant spent ~70% of the
// 4K parse merging and rebuilding those lists).
struct ChunkState {
  std::vector<uint64_t> insig;  // bit = not yet significant
  std::vector<uint64_t> sig;    // bit = significant before this plane
  std::vector<uint64_t> newly;  // bit = became significant this plane
  int64_t insig_count = 0;
  int64_t sig_count = 0;
  bool init = false;

  void ensure(int64_t num) {
    if (init) return;
    size_t nw = static_cast<size_t>((num + 63) / 64);
    insig.assign(nw, ~0ull);
    if (num & 63) insig[nw - 1] = (1ull << (num & 63)) - 1;
    sig.assign(nw, 0);
    newly.assign(nw, 0);
    insig_count = num;
    init = true;
  }
};

inline uint64_t mask64(int n) { return n >= 64 ? ~0ull : ((1ull << n) - 1); }

// Position of the r-th (0-based) set bit of w; r < popcount(w).
inline int select_bit(uint64_t w, int r) {
#ifdef __BMI2__
  return __builtin_ctzll(_pdep_u64(1ull << r, w));
#else
  for (int i = 0; i < r; ++i) w &= w - 1;
  return __builtin_ctzll(w);
#endif
}

// Deposit the low popcount(mask) bits of bits_ onto the set positions of
// mask, in ascending order (bit j of bits_ -> j-th set position).
inline uint64_t deposit(uint64_t bits_, uint64_t mask) {
#ifdef __BMI2__
  return _pdep_u64(bits_, mask);
#else
  uint64_t out = 0;
  while (mask) {
    uint64_t low = mask & -mask;
    if (bits_ & 1) out |= low;
    bits_ >>= 1;
    mask &= mask - 1;
  }
  return out;
#endif
}

// One (chunk, plane) coding step.  Returns 0, or -1 on EOF (partial
// updates keep exactly the reference's sequence-point semantics: value
// bits are only written where the reference would have written them).
int decode_plane(RleReader* rle, int32_t* val, int64_t num, int plane,
                 ChunkState* cs) {
  uint32_t bit_mask = plane >= 0 ? (1u << plane) : 0u;
  cs->ensure(num);
  const size_t nw = cs->insig.size();
  bool newly_any = false;

  // Significance pass: run-jump over the insig bitmask (snapshot — newly
  // bits are only folded in at the promote step, exactly like the
  // reference's sig flag that is tested before it is set this plane).
  // get_rle/counter semantics (rle.h:66-77): reading run R makes the
  // current position zero #1 of R, and position (cursor + R) significant;
  // a pending counter c makes position (cursor + c - 1) significant.
  //
  // The whole pass runs on LOCAL copies of the bit/VLI/RLE state (the
  // pointer-chained originals defeat register allocation across the
  // per-symbol loop — measured ~74% of a 4K parse lives here); state
  // syncs back on every exit.
  {
    BitReader* br = rle->vli->bits;
    const uint8_t* data = br->data;
    const int64_t nbytes = br->nbytes;
    uint64_t acc = br->acc;
    int navail = br->navail;
    int64_t bpos = br->pos;
    int order = rle->vli->order;
    int64_t rcnt = rle->cnt;
    if (br->fail) return -1;

    auto sync = [&]() {
      br->acc = acc;
      br->navail = navail;
      br->pos = bpos;
      rle->vli->order = order;
      rle->cnt = rcnt;
    };
    auto refill = [&]() {
      if (navail <= 56 && bpos + 8 <= nbytes) {
        uint64_t w;
        std::memcpy(&w, data + bpos, 8);
        int take = (64 - navail) >> 3;
        if (take < 8) w &= (1ull << (take << 3)) - 1;
        acc |= w << navail;
        bpos += take;
        navail += take << 3;
        return;
      }
      while (navail <= 56 && bpos < nbytes) {
        acc |= static_cast<uint64_t>(data[bpos++]) << navail;
        navail += 8;
      }
    };
    // Adaptive VLI get (see VliReader::get); -1 = EOF/corrupt, with
    // br->fail set exactly where the member version would set it.
    auto vget = [&]() -> int64_t {
      int64_t sum = 0;
      for (;;) {
        if (navail == 0) {
          refill();
          if (navail == 0) {
            br->fail = true;
            return -1;
          }
        }
        if (acc != 0) {
          int z = __builtin_ctzll(acc);
          if (order + z > 48) return -1;
          sum += ((1ll << z) - 1) << order;
          order += z;
          acc >>= z + 1;
          navail -= z + 1;
          break;
        }
        int n = navail;
        if (order + n > 48) return -1;
        sum += ((1ll << n) - 1) << order;
        order += n;
        acc = 0;
        navail = 0;
      }
      if (navail < order) refill();
      int64_t v;
      if (navail >= order) {
        v = static_cast<int64_t>(acc & ((1ull << order) - 1));
        acc >>= order;
        navail -= order;
      } else {
        v = 0;
        for (int i = 0; i < order; ++i) {
          if (navail == 0) {
            refill();
            if (navail == 0) {
              br->fail = true;
              return -1;
            }
          }
          v |= static_cast<int64_t>(acc & 1) << i;
          acc >>= 1;
          navail -= 1;
        }
      }
      order -= 2;
      if (order < 0) order = 0;
      return v + sum;
    };

    int64_t remaining = cs->insig_count;
    size_t wi = 0;
    uint64_t cur = remaining ? cs->insig[0] : 0;  // word wi, consumed
    while (remaining > 0) {                       // bits cleared
      int64_t skip;  // insignificant positions skipped before the 1-bit
      if (rcnt == 0) {
        int64_t r = vget();
        if (r < 0) {
          sync();
          return -1;
        }
        if (r >= remaining) {
          rcnt = r - remaining + 1;
          break;
        }
        skip = r;
      } else {
        if (rcnt > remaining) {
          rcnt -= remaining;
          break;
        }
        skip = rcnt - 1;
        rcnt = 0;
      }
      // Advance `skip` set bits; the next one becomes significant.
      remaining -= skip + 1;
      for (;;) {
        int pc = __builtin_popcountll(cur);
        if (skip < pc) break;
        skip -= pc;
        cur = cs->insig[++wi];
      }
      int b = select_bit(cur, static_cast<int>(skip));
      cur = (b == 63) ? 0 : (cur & ~((2ull << b) - 1));
      int64_t pos = static_cast<int64_t>(wi) * 64 + b;
      if (navail == 0) {
        refill();
        if (navail == 0) {
          // The reference writes the significance bit BEFORE reading the
          // sign (decode.c:79-83) — on EOF at the sign read the bit must
          // survive (partial-truncation parity).
          val[pos] = static_cast<int32_t>(static_cast<uint32_t>(val[pos]) |
                                          bit_mask);
          br->fail = true;
          sync();
          return -1;
        }
      }
      uint32_t s = static_cast<uint32_t>(acc & 1);
      acc >>= 1;
      navail -= 1;
      val[pos] = static_cast<int32_t>(
          static_cast<uint32_t>(val[pos]) | bit_mask |
          (s << kSgnBit) | kSigMask);
      cs->newly[wi] |= 1ull << b;
      newly_any = true;
    }
    sync();
  }

  // Refinement pass over previously-significant positions (position
  // order): per sig word with c set bits, pull c stream bits and deposit
  // them onto the set positions with one pdep; only actual 1-bits are
  // visited (ctz walk).
  if (cs->sig_count > 0) {
    BitReader* br = rle->vli->bits;
    size_t w = 0;
    uint64_t sw = cs->sig[0];
    if (rle->cnt > 0) {  // first bit must close the pending run exactly
      while (!sw) sw = cs->sig[++w];
      int b = rle->get_bit();
      if (b < 0) return -1;
      int t = __builtin_ctzll(sw);
      if (b)
        val[w * 64 + t] = static_cast<int32_t>(
            static_cast<uint32_t>(val[w * 64 + t]) | bit_mask);
      sw &= sw - 1;
    }
    for (;;) {
      int c = __builtin_popcountll(sw);
      if (c) {
        uint64_t bits_ = 0;
        int got = 0;
        while (got < c) {
          if (br->navail == 0) br->refill();
          int take = c - got;
          if (take > br->navail) take = br->navail;
          if (take > 63) take = 63;  // acc >>= 64 is UB (would re-read bits)
          if (take == 0) {
            // EOF mid-pass: apply the bits obtained so far to the lowest
            // set positions (the serial decoder would have), then stop.
            uint64_t swl = sw;
            for (int k = 0; k < got; ++k) {
              int t = __builtin_ctzll(swl);
              swl &= swl - 1;
              if ((bits_ >> k) & 1)
                val[w * 64 + t] = static_cast<int32_t>(
                    static_cast<uint32_t>(val[w * 64 + t]) | bit_mask);
            }
            br->fail = true;
            return -1;
          }
          bits_ |= (br->acc & mask64(take)) << got;
          br->acc >>= take;
          br->navail -= take;
          got += take;
        }
        uint64_t setpos = deposit(bits_, sw);
        while (setpos) {
          int t = __builtin_ctzll(setpos);
          setpos &= setpos - 1;
          val[w * 64 + t] = static_cast<int32_t>(
              static_cast<uint32_t>(val[w * 64 + t]) | bit_mask);
        }
      }
      if (++w >= nw) break;
      sw = cs->sig[w];
    }
  }

  // Promote: fold newly into sig / out of insig (word ORs, no rebuilds).
  if (newly_any) {
    int64_t cnt = 0;
    for (size_t w = 0; w < nw; ++w) {
      uint64_t nv = cs->newly[w];
      if (!nv) continue;
      cs->sig[w] |= nv;
      cs->insig[w] &= ~nv;
      cs->newly[w] = 0;
      cnt += __builtin_popcountll(nv);
    }
    cs->sig_count += cnt;
    cs->insig_count -= cnt;
  }
  return 0;
}

}  // namespace

extern "C" {

// Full entropy decode of the post-header bitstream.
//
//   stream/nbytes : bitstream bytes (starting right after the 6-byte header)
//   channels      : 1 or 3
//   levels        : pyramid levels; pixels[] has levels+1 entries
//   levels_max    : reduced-resolution cap (== levels for full decode)
//   pixels        : linear offsets per level (geometry.py Pyramid.pixels)
//   out           : (channels, total) planar int32, zero-initialized by caller
//   missing       : (channels, 16) int32, filled with remaining plane counts
//   out_level     : deepest detail level actually decoded (-1 if none)
//   out_planes    : (channels,) decoded plane counts
//
// Returns 0 on success (including graceful truncation), -1 on hard error
// (header/root/planes unreadable -> reference exits with no output).
int dwt_entropy_decode(const uint8_t* stream, int64_t nbytes, int channels,
                       int levels, int levels_max, const int64_t* pixels,
                       int32_t* out, int32_t* missing, int32_t* out_level,
                       int32_t* out_planes) {
  BitReader bits{stream, nbytes};
  VliReader vli{&bits};
  const int64_t total = pixels[levels];
  const int64_t pix0 = pixels[0];

  // Root band (decode.c:119-134): any EOF here is a hard error.  `cnt` is
  // attacker-controlled: values outside [0, 32] would make read_bits shift
  // by >= 64 (UB); no valid stream exceeds 29 bits of magnitude (the
  // format's 2^29 magnitude ceiling, encode.c:115-128), so hard-error like
  // the reference effectively does (it would hit EOF reading that many
  // bits per coefficient).
  for (int c = 0; c < channels; ++c) {
    int64_t cnt = vli.get();
    if (cnt < 0 || cnt > 32) return -1;
    if (cnt) {
      int32_t* row = out + static_cast<int64_t>(c) * total;
      for (int64_t i = 0; i < pix0; ++i) {
        int64_t v = bits.read_bits(static_cast<int>(cnt));
        if (v < 0) return -1;
        if (v) {
          int s = bits.get_bit();
          if (s < 0) return -1;
          if (s) v = -v;
        }
        row[i] = static_cast<int32_t>(v);
      }
    }
  }
  int planes[4] = {0, 0, 0, 0};
  int planes_max = 0;
  // Plane counts outside [0, 31] would drive decode_plane with
  // `1u << plane` UB; valid streams never exceed 29 (magnitude ceiling).
  for (int c = 0; c < channels; ++c) {
    int64_t p = vli.get();
    if (p < 0 || p > 31) return -1;
    planes[c] = static_cast<int>(p);
    out_planes[c] = planes[c];
    if (planes[c] > planes_max) planes_max = planes[c];
  }
  for (int c = 0; c < channels; ++c)
    for (int l = 0; l < 16; ++l)
      missing[c * 16 + l] = l < levels ? planes[c] : 0;

  int level = -1;
  RleReader rle{&vli};
  int maximum = levels > planes_max ? levels : planes_max;
  int layers_max = 2 * maximum - 1;
  std::vector<ChunkState> states(static_cast<size_t>(channels) * levels);

  // Layer schedule replay (decode.c:199-243).  A macro-free structured
  // version of the reference's goto-end control flow.
  bool stop = levels_max <= 0;
  if (!stop && planes_max == planes[0]) {
    // Pre-step: top luma plane of the coarsest chunk (decode.c:199-205).
    level = 0;
    if (decode_plane(&rle, out + pix0, pixels[1] - pix0, planes[0] - 1,
                     &states[0]) != 0)
      stop = true;
    else
      --missing[0];
  }
  for (int layers = 0; !stop && layers < layers_max; ++layers) {
    for (int l = 0; l < levels && l <= layers + 1; ++l) {
      if (l >= levels_max) { stop = true; break; }
      int plane = planes_max - 1 - (layers + 1 - l);
      if (plane < 0 || plane >= planes[0]) continue;
      if (level < l) level = l;
      if (decode_plane(&rle, out + pixels[l], pixels[l + 1] - pixels[l],
                       plane, &states[l]) != 0) { stop = true; break; }
      --missing[l];
    }
    for (int l = 0; !stop && l < levels && l <= layers; ++l) {
      if (l >= levels_max) { stop = true; break; }
      for (int c = 1; c < channels; ++c) {
        int plane = planes_max - 1 - (layers - l);
        if (plane < 0 || plane >= planes[c]) continue;
        if (level < l) level = l;
        if (decode_plane(&rle, out + static_cast<int64_t>(c) * total + pixels[l],
                         pixels[l + 1] - pixels[l], plane,
                         &states[static_cast<size_t>(c) * levels + l]) != 0) {
          stop = true;
          break;
        }
        --missing[c * 16 + l];
      }
    }
  }

  // Strip coding-state flags; sign-magnitude -> two's complement
  // (decode.c:102-117), over the decoded detail range only.
  int64_t ndet = (level + 1 <= levels ? pixels[level + 1] : total) - pix0;
  if (ndet < 0) ndet = 0;
  for (int c = 0; c < channels; ++c) {
    int32_t* row = out + static_cast<int64_t>(c) * total + pix0;
    for (int64_t i = 0; i < ndet; ++i) {
      uint32_t v = static_cast<uint32_t>(row[i]) & ~(kSigMask | kRefMask);
      int32_t w = static_cast<int32_t>(v & ~kSgnMask);
      row[i] = (v & kSgnMask) ? -w : w;
    }
  }
  *out_level = level;
  return 0;
}

// Batch decode of many independent streams (tiles of the .dwtt container
// or frames), fanned out over a host thread pool.  All tiles share one
// geometry (pixels/levels); per-tile stream offsets index into `streams`.
//
//   n            : number of tiles
//   streams      : concatenated tile payloads
//   offsets      : (n+1,) byte offsets into streams
//   out          : (n, channels, total) int32, zero-initialized
//   missing      : (n, channels, 16)
//   out_level    : (n,)
//   out_planes   : (n, channels)
//   rc           : (n,) per-tile return codes
//   nthreads     : 0 = hardware concurrency
int dwt_entropy_decode_batch(const uint8_t* streams, const int64_t* offsets,
                             int n, int channels, int levels, int levels_max,
                             const int64_t* pixels, int32_t* out,
                             int32_t* missing, int32_t* out_level,
                             int32_t* out_planes, int32_t* rc, int nthreads) {
  const int64_t total = pixels[levels];
  if (nthreads <= 0) {
    nthreads = static_cast<int>(std::thread::hardware_concurrency());
    if (nthreads <= 0) nthreads = 4;
  }
  std::atomic<int> next{0};
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      rc[i] = dwt_entropy_decode(
          streams + offsets[i], offsets[i + 1] - offsets[i], channels, levels,
          levels_max, pixels, out + static_cast<int64_t>(i) * channels * total,
          missing + static_cast<int64_t>(i) * channels * 16, out_level + i,
          out_planes + static_cast<int64_t>(i) * channels);
    }
  };
  std::vector<std::thread> pool;
  int nt = nthreads < n ? nthreads : n;
  for (int t = 0; t < nt; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return 0;
}

// Parallel zero-fill of a coefficient buffer.  The decoder's output array
// must be zero-initialized (values accumulate via OR); a fresh np.zeros
// defers that cost to first-touch page faults INSIDE the timed parse
// (~30-50 ms for a 4K frame's 100 MB).  Faulting + zeroing the pages from
// all cores up front is both faster and attributable.
void dwt_zero_i32(int32_t* buf, int64_t n, int nthreads) {
  if (nthreads <= 0) {
    nthreads = static_cast<int>(std::thread::hardware_concurrency());
    if (nthreads <= 0) nthreads = 4;
  }
  if (n < (1 << 20) || nthreads == 1) {
    std::memset(buf, 0, static_cast<size_t>(n) * 4);
    return;
  }
  std::vector<std::thread> pool;
  int64_t chunk = (n + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; ++t) {
    int64_t a = t * chunk;
    int64_t b = a + chunk < n ? a + chunk : n;
    if (a >= b) break;
    pool.emplace_back([buf, a, b]() {
      std::memset(buf + a, 0, static_cast<size_t>(b - a) * 4);
    });
  }
  for (auto& th : pool) th.join();
}

}  // extern "C"
