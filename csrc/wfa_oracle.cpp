// Scalar wavefront-alignment oracle (C++), exact gap-affine and
// two-piece-affine global alignment with full traceback.
//
// Fresh implementation of the wavefront recurrences (Marco-Sola et al.
// 2021/2023) — NOT derived from WFA2-lib. Semantics and tie-breaking are
// identical to allwave/wfa/reference_impl.py (the Python oracle):
//   * pattern = query (v), text = target (h), diagonal k = h - v,
//     offsets store h; lower score better; match cost 0.
//   * CIGAR bytes in the WFA2 convention: M/X, 'I' consumes target,
//     'D' consumes query.
//   * M-candidate tie-break order: X, I1, I2, D1, D2; gap chains prefer
//     extend over open (TIEBREAK_M / TIEBREAK_GAP in reference_impl.py).
//
// Used as: conformance cross-check for the device engines, host fallback
// path, and the single-core CPU baseline proxy in bench.py.
//
// Build: make -C csrc   (produces liballwave_native.so)

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

constexpr int32_t kNull = INT32_MIN / 2;

struct Wavefront {
  int lo = 0, hi = -1;           // inclusive diagonal range; empty if lo>hi
  std::vector<int32_t> m, i1, d1, i2, d2;

  bool empty() const { return lo > hi; }
  void init(int lo_, int hi_, bool two_piece) {
    lo = lo_; hi = hi_;
    size_t w = static_cast<size_t>(hi - lo + 1);
    m.assign(w, kNull);
    i1.assign(w, kNull);
    d1.assign(w, kNull);
    if (two_piece) { i2.assign(w, kNull); d2.assign(w, kNull); }
  }
  int32_t get(const std::vector<int32_t>& arr, int k) const {
    if (arr.empty() || k < lo || k > hi) return kNull;
    return arr[static_cast<size_t>(k - lo)];
  }
  int32_t gm(int k) const { return get(m, k); }
  int32_t gi1(int k) const { return get(i1, k); }
  int32_t gd1(int k) const { return get(d1, k); }
  int32_t gi2(int k) const { return get(i2, k); }
  int32_t gd2(int k) const { return get(d2, k); }
};

struct Penalties {
  int32_t x, o1, e1, o2, e2;
  bool two_piece;
};

class Aligner {
 public:
  Aligner(const Penalties& pen) : pen_(pen) {}

  // Returns score >= 0 on success, -1 if s_cap exceeded. CIGAR ops are
  // appended to `cigar` in forward order.
  int align(const uint8_t* q, int plen, const uint8_t* t, int tlen,
            int s_cap, std::vector<uint8_t>* cigar) {
    int score = align_rle(q, plen, t, tlen, s_cap);
    if (score < 0) return score;
    // expand the (reversed) run list into forward per-base op bytes
    for (size_t r = rev_ops_.size(); r-- > 0;) {
      for (int32_t i = 0; i < rev_lens_[r]; ++i) cigar->push_back(rev_ops_[r]);
    }
    return score;
  }

  // Run-length variant with buffer reuse across calls: the wavefront
  // history pool, run buffers, and op-count accumulators are members,
  // so a batch loop pays zero per-pair heap allocation once warm.
  // On success the runs are in rev_ops_/rev_lens_ in REVERSE order
  // (walk order); op counts are in m_cnt_/x_cnt_/i_cnt_/d_cnt_.
  int align_rle(const uint8_t* q, int plen, const uint8_t* t, int tlen,
                int s_cap) {
    plen_ = plen; tlen_ = tlen; q_ = q; t_ = t;
    k_end_ = tlen - plen;
    hist_n_ = 0;
    rev_ops_.clear();
    rev_lens_.clear();
    m_cnt_ = x_cnt_ = i_cnt_ = d_cnt_ = 0;

    if (plen == 0 && tlen == 0) return 0;

    {
      Wavefront& wf0 = next_wf();
      wf0.init(0, 0, pen_.two_piece);
      int32_t h = extend(0, 0);
      wf0.m[0] = trim(h, 0);
      if (wf0.gm(k_end_) == tlen_) {
        backtrace(0);
        return 0;
      }
    }
    for (int s = 1; s <= s_cap; ++s) {
      compute_next(s);
      if (pool_[static_cast<size_t>(s)].gm(k_end_) == tlen_) {
        backtrace(s);
        return s;
      }
    }
    return -1;
  }

  const std::vector<uint8_t>& rev_ops() const { return rev_ops_; }
  const std::vector<int32_t>& rev_lens() const { return rev_lens_; }
  int64_t m_cnt() const { return m_cnt_; }
  int64_t x_cnt() const { return x_cnt_; }
  int64_t i_cnt() const { return i_cnt_; }
  int64_t d_cnt() const { return d_cnt_; }

 private:
  int32_t h_max(int k) const {
    int32_t a = tlen_;
    int32_t b = plen_ + k;
    int32_t hm = a < b ? a : b;
    if (k < -plen_ || k > tlen_) return -1;
    return hm;
  }
  int32_t trim(int32_t h, int k) const { return h > h_max(k) ? kNull : h; }

  int32_t extend(int32_t h, int k) const {
    if (h <= kNull) return h;
    int32_t v = h - k;
    // quad-at-a-time greedy extension; memcmp-free to keep it simple
    while (v + 4 <= plen_ && h + 4 <= tlen_ &&
           std::memcmp(q_ + v, t_ + h, 4) == 0) { v += 4; h += 4; }
    while (v < plen_ && h < tlen_ && q_[v] == t_[h]) { ++v; ++h; }
    return h;
  }

  const Wavefront* prev(int s) const {
    if (s < 0 || s >= hist_n_) return nullptr;
    const Wavefront& w = pool_[static_cast<size_t>(s)];
    return w.empty() ? nullptr : &w;
  }

  // Next history slot, reusing pooled Wavefront objects (their member
  // vectors keep capacity across pairs, so re-init is assign()-only).
  Wavefront& next_wf() {
    if (static_cast<int>(pool_.size()) <= hist_n_) pool_.emplace_back();
    Wavefront& w = pool_[static_cast<size_t>(hist_n_++)];
    w.lo = 1; w.hi = -1;  // empty until init()
    return w;
  }

  void compute_next(int s) {
    // allocate the slot FIRST: next_wf may reallocate the pool, which
    // would invalidate prev() pointers captured before it
    Wavefront& wf = next_wf();
    const Wavefront* wx = prev(s - pen_.x);
    const Wavefront* wo1 = prev(s - pen_.o1 - pen_.e1);
    const Wavefront* we1 = prev(s - pen_.e1);
    const Wavefront* wo2 = pen_.two_piece ? prev(s - pen_.o2 - pen_.e2) : nullptr;
    const Wavefront* we2 = pen_.two_piece ? prev(s - pen_.e2) : nullptr;

    int lo = 1, hi = -1;  // empty
    auto acc = [&](const Wavefront* w) {
      if (!w) return;
      if (hi < lo) { lo = w->lo; hi = w->hi; }
      else { lo = w->lo < lo ? w->lo : lo; hi = w->hi > hi ? w->hi : hi; }
    };
    acc(wx); acc(wo1); acc(we1); acc(wo2); acc(we2);

    if (hi >= lo) {
      lo = (lo - 1 < -plen_) ? -plen_ : lo - 1;
      hi = (hi + 1 > tlen_) ? tlen_ : hi + 1;
      if (lo <= hi) {
        wf.init(lo, hi, pen_.two_piece);
        for (int k = lo; k <= hi; ++k) {
          size_t idx = static_cast<size_t>(k - lo);
          // I1 / D1
          int32_t iopen = wo1 ? wo1->gm(k - 1) : kNull;
          int32_t iext = we1 ? we1->gi1(k - 1) : kNull;
          int32_t i1 = iopen > iext ? iopen : iext;
          wf.i1[idx] = trim(i1 > kNull ? i1 + 1 : kNull, k);
          int32_t dopen = wo1 ? wo1->gm(k + 1) : kNull;
          int32_t dext = we1 ? we1->gd1(k + 1) : kNull;
          wf.d1[idx] = trim(dopen > dext ? dopen : dext, k);
          int32_t best = wf.i1[idx] > wf.d1[idx] ? wf.i1[idx] : wf.d1[idx];
          if (pen_.two_piece) {
            int32_t i2open = wo2 ? wo2->gm(k - 1) : kNull;
            int32_t i2ext = we2 ? we2->gi2(k - 1) : kNull;
            int32_t i2 = i2open > i2ext ? i2open : i2ext;
            wf.i2[idx] = trim(i2 > kNull ? i2 + 1 : kNull, k);
            int32_t d2open = wo2 ? wo2->gm(k + 1) : kNull;
            int32_t d2ext = we2 ? we2->gd2(k + 1) : kNull;
            wf.d2[idx] = trim(d2open > d2ext ? d2open : d2ext, k);
            int32_t b2 = wf.i2[idx] > wf.d2[idx] ? wf.i2[idx] : wf.d2[idx];
            best = best > b2 ? best : b2;
          }
          int32_t mis = wx ? wx->gm(k) : kNull;
          mis = trim(mis > kNull ? mis + 1 : kNull, k);
          int32_t pre = best > mis ? best : mis;
          wf.m[idx] = trim(extend(pre, k), k);
        }
      }
    }
  }

  // Append a run to the reversed run list, merging with the last run.
  void push_run(uint8_t op, int32_t cnt) {
    if (cnt <= 0) return;
    if (!rev_ops_.empty() && rev_ops_.back() == op) {
      rev_lens_.back() += cnt;
    } else {
      rev_ops_.push_back(op);
      rev_lens_.push_back(cnt);
    }
  }

  void backtrace(int s_final) {
    int s = s_final, k = k_end_;
    int comp = 0;  // 0=M 1=I1 2=D1 3=I2 4=D2
    int32_t h = pool_[static_cast<size_t>(s)].gm(k);

    auto hget = [&](int sc, int comp_id, int kk) -> int32_t {
      const Wavefront* w = prev(sc);
      if (!w) return kNull;
      switch (comp_id) {
        case 0: return w->gm(kk);
        case 1: return w->gi1(kk);
        case 2: return w->gd1(kk);
        case 3: return w->gi2(kk);
        default: return w->gd2(kk);
      }
    };

    while (true) {
      if (comp == 0) {
        if (s == 0) {
          push_run('M', h);
          m_cnt_ += h;
          break;
        }
        int32_t mis = hget(s - pen_.x, 0, k);
        int32_t cx = mis > kNull ? mis + 1 : kNull;
        int32_t ci1 = hget(s, 1, k);
        int32_t cd1 = hget(s, 2, k);
        int32_t ci2 = pen_.two_piece ? hget(s, 3, k) : kNull;
        int32_t cd2 = pen_.two_piece ? hget(s, 4, k) : kNull;
        int32_t pre = cx;
        if (ci1 > pre) pre = ci1;
        if (cd1 > pre) pre = cd1;
        if (ci2 > pre) pre = ci2;
        if (cd2 > pre) pre = cd2;
        push_run('M', h - pre);
        m_cnt_ += h - pre;
        h = pre;
        // tie-break: X, I1, I2, D1, D2
        if (cx == pre) {
          push_run('X', 1);
          ++x_cnt_;
          s -= pen_.x;
          h -= 1;
        } else if (ci1 == pre) {
          comp = 1;
        } else if (ci2 == pre) {
          comp = 3;
        } else if (cd1 == pre) {
          comp = 2;
        } else {
          comp = 4;
        }
      } else if (comp == 1 || comp == 3) {  // I1 / I2 (consume target)
        int32_t o = comp == 1 ? pen_.o1 : pen_.o2;
        int32_t e = comp == 1 ? pen_.e1 : pen_.e2;
        int32_t ext = hget(s - e, comp, k - 1);
        int32_t opn = hget(s - o - e, 0, k - 1);
        push_run('I', 1);
        ++i_cnt_;
        if (ext > kNull && ext + 1 == h) {
          s -= e;
        } else if (opn > kNull && opn + 1 == h) {
          s -= o + e;
          comp = 0;
        } else {
          std::abort();  // inconsistent history
        }
        h -= 1;
        k -= 1;
      } else {  // D1 / D2 (consume query)
        int32_t o = comp == 2 ? pen_.o1 : pen_.o2;
        int32_t e = comp == 2 ? pen_.e1 : pen_.e2;
        int32_t ext = hget(s - e, comp, k + 1);
        int32_t opn = hget(s - o - e, 0, k + 1);
        push_run('D', 1);
        ++d_cnt_;
        if (ext > kNull && ext == h) {
          s -= e;
        } else if (opn > kNull && opn == h) {
          s -= o + e;
          comp = 0;
        } else {
          std::abort();
        }
        k += 1;
      }
    }
  }

  Penalties pen_;
  const uint8_t* q_ = nullptr;
  const uint8_t* t_ = nullptr;
  int plen_ = 0, tlen_ = 0, k_end_ = 0;
  std::vector<Wavefront> pool_;  // reused history slots (index = score)
  int hist_n_ = 0;               // live history length
  std::vector<uint8_t> rev_ops_;  // reversed RLE runs of the last walk
  std::vector<int32_t> rev_lens_;
  int64_t m_cnt_ = 0, x_cnt_ = 0, i_cnt_ = 0, d_cnt_ = 0;
};

}  // namespace

extern "C" {

// Aligns one pair. Returns the score (>=0) or -1 (s_cap exceeded) or -2
// (cigar buffer too small). On success writes the CIGAR (one op byte per
// aligned base, WFA2 convention) and its length.
int wfa_align_single(const uint8_t* query, int32_t qlen, const uint8_t* target,
                     int32_t tlen, int32_t x, int32_t o1, int32_t e1,
                     int32_t o2, int32_t e2, int32_t two_piece, int32_t s_cap,
                     uint8_t* cigar_out, int64_t cigar_cap,
                     int64_t* cigar_len) {
  Penalties pen{x, o1, e1, o2, e2, two_piece != 0};
  Aligner a(pen);
  std::vector<uint8_t> cig;
  int score = a.align(query, qlen, target, tlen, s_cap, &cig);
  if (score < 0) return -1;
  if (static_cast<int64_t>(cig.size()) > cigar_cap) return -2;
  std::memcpy(cigar_out, cig.data(), cig.size());
  *cigar_len = static_cast<int64_t>(cig.size());
  return score;
}

// Batch API: sequences are concatenated; offsets/lengths index into them.
// cigars are written back-to-back into cigar_out with per-pair offsets
// recorded in cigar_offsets (length n+1, offsets[0] must be 0 on entry).
// scores[i] = -1 for failed pairs (their cigar is empty).
int wfa_align_batch(const uint8_t* qbuf, const int64_t* qoff,
                    const int32_t* qlen, const uint8_t* tbuf,
                    const int64_t* toff, const int32_t* tlen, int32_t n,
                    int32_t x, int32_t o1, int32_t e1, int32_t o2, int32_t e2,
                    int32_t two_piece, int32_t s_cap, uint8_t* cigar_out,
                    int64_t cigar_cap, int64_t* cigar_offsets,
                    int32_t* scores) {
  Penalties pen{x, o1, e1, o2, e2, two_piece != 0};
  Aligner a(pen);  // one aligner: history buffers reused across pairs
  int64_t pos = 0;
  for (int32_t i = 0; i < n; ++i) {
    std::vector<uint8_t> cig;
    int score = a.align(qbuf + qoff[i], qlen[i], tbuf + toff[i], tlen[i],
                        s_cap, &cig);
    if (score >= 0) {
      if (pos + static_cast<int64_t>(cig.size()) > cigar_cap) return -2;
      std::memcpy(cigar_out + pos, cig.data(), cig.size());
      pos += static_cast<int64_t>(cig.size());
    }
    scores[i] = score;
    cigar_offsets[i + 1] = pos;
  }
  return 0;
}

// Run-length batch API: aligns n pairs addressed into ONE pooled
// sequence buffer (qoff/toff are byte offsets into `pool`). Per pair:
//   scores[i]    = alignment score, or -1 if s_cap exceeded;
//   runs         = forward-order RLE (run_ops uint8 / run_lens int32)
//                  written back-to-back, per-pair extent in
//                  run_offsets[i]..run_offsets[i+1] (run_offsets[0]
//                  must be 0 on entry);
//   stats[4*i..] = {#M, #X, #I, #D} op counts (int64).
// One Aligner instance serves every pair, so wavefront history and run
// buffers are heap-allocated once per batch, not per pair.
// Returns 0, or -2 if run_cap was exceeded.
int wfa_align_batch_rle(const uint8_t* pool, const int64_t* qoff,
                        const int32_t* qlen, const int64_t* toff,
                        const int32_t* tlen, int32_t n, int32_t x, int32_t o1,
                        int32_t e1, int32_t o2, int32_t e2, int32_t two_piece,
                        int32_t s_cap, uint8_t* run_ops, int32_t* run_lens,
                        int64_t run_cap, int64_t* run_offsets, int32_t* scores,
                        int64_t* stats) {
  Penalties pen{x, o1, e1, o2, e2, two_piece != 0};
  Aligner a(pen);
  int64_t pos = 0;
  for (int32_t i = 0; i < n; ++i) {
    int score = a.align_rle(pool + qoff[i], qlen[i], pool + toff[i], tlen[i],
                            s_cap);
    scores[i] = score;
    if (score >= 0) {
      const std::vector<uint8_t>& ro = a.rev_ops();
      const std::vector<int32_t>& rl = a.rev_lens();
      int64_t nr = static_cast<int64_t>(ro.size());
      if (pos + nr > run_cap) return -2;
      for (int64_t r = 0; r < nr; ++r) {  // reversed walk -> forward runs
        run_ops[pos + r] = ro[static_cast<size_t>(nr - 1 - r)];
        run_lens[pos + r] = rl[static_cast<size_t>(nr - 1 - r)];
      }
      pos += nr;
      stats[4 * i + 0] = a.m_cnt();
      stats[4 * i + 1] = a.x_cnt();
      stats[4 * i + 2] = a.i_cnt();
      stats[4 * i + 3] = a.d_cnt();
    } else {
      stats[4 * i + 0] = stats[4 * i + 1] = stats[4 * i + 2] =
          stats[4 * i + 3] = 0;
    }
    run_offsets[i + 1] = pos;
  }
  return 0;
}

}  // extern "C"
