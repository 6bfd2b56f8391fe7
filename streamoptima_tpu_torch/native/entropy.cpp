// Native host runtime: diagonal-scan RLE entropy coding + residual-line
// serialization.
//
// The TPU device produces fixed-shape quantized-coefficient arrays; turning
// them into the reference's variable-length text bitstream (entropy_encoder_
// frame, Encoder.py:1522-1542, RLE per block Encoder.py:1086-1131) is pure
// host work and the slowest non-device stage of the pipeline when done in
// Python.  This translation unit emits the exact same bytes the Python twin
// (streamoptima_tpu_torch/bitstream.py) produces, including the numpy>=2
// "np.int64(v)" scalar reprs the reference's file format exhibits.
//
// Built by streamoptima_tpu_torch/native/__init__.py with g++ -O3 at first use;
// all entry points are plain C ABI for ctypes.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// Diagonal (anti-diagonal raster) visit order, the k-loop of
// Encoder.py:1086-1131: start (0,k) for k<n else (k-n+1, n-1), walk
// down-left.  Flat indices into a row-major n*n block.
std::vector<int32_t> diag_indices(int n) {
  std::vector<int32_t> order;
  order.reserve(n * n);
  for (int k = 0; k < 2 * n - 1; ++k) {
    int i = k < n ? 0 : k - n + 1;
    int j = k < n ? k : n - 1;
    while (i < n && j >= 0) {
      order.push_back(i * n + j);
      ++i;
      --j;
    }
  }
  return order;
}

struct Writer {
  char* buf;
  int64_t cap;
  int64_t len = 0;
  bool overflow = false;

  inline void put(char c) {
    if (len >= cap) { overflow = true; return; }
    buf[len++] = c;
  }
  inline void puts(const char* s) {
    while (*s) put(*s++);
  }
  inline void put_int(int64_t v) {
    char tmp[24];
    int t = 0;
    bool neg = v < 0;
    uint64_t u = neg ? (uint64_t)(-(v + 1)) + 1 : (uint64_t)v;
    do { tmp[t++] = '0' + (char)(u % 10); u /= 10; } while (u);
    if (neg) put('-');
    while (t) put(tmp[--t]);
  }
};

// RLE-encode one block's diagonal sequence and append its Python-list text
// ("[a, b, c]"); values wrapped as np.int64(v) when numpy_repr (run headers
// and zero counts stay plain, matching rle_encode_block in core/zigzag.py).
void emit_block(Writer& w, const int64_t* block, const std::vector<int32_t>& idx,
                bool numpy_repr) {
  const int total = (int)idx.size();
  w.put('[');
  bool first = true;
  auto sep = [&]() {
    if (!first) w.puts(", ");
    first = false;
  };
  int run_start = -1;  // start of current nonzero run in seq order
  int run_len = 0;
  int zero_count = 0;
  bool emitted_nonzero = false;
  // local copy of the sequence values for the pending nonzero run
  std::vector<int64_t> run_vals;
  run_vals.reserve(total);
  for (int s = 0; s < total; ++s) {
    int64_t v = block[idx[s]];
    if (v != 0) {
      if (run_vals.empty() && zero_count) {
        sep();
        w.put_int(zero_count);
        zero_count = 0;
      }
      run_vals.push_back(v);
    } else {
      if (!run_vals.empty()) {
        sep();
        w.put_int(-(int64_t)run_vals.size());
        for (int64_t rv : run_vals) {
          w.puts(", ");
          if (numpy_repr) { w.puts("np.int64("); w.put_int(rv); w.put(')'); }
          else w.put_int(rv);
        }
        run_vals.clear();
        emitted_nonzero = true;
      }
      ++zero_count;
    }
  }
  if (!run_vals.empty()) {
    sep();
    w.put_int(-(int64_t)run_vals.size());
    for (int64_t rv : run_vals) {
      w.puts(", ");
      if (numpy_repr) { w.puts("np.int64("); w.put_int(rv); w.put(')'); }
      else w.put_int(rv);
    }
    emitted_nonzero = true;
  }
  if (zero_count) {
    sep();
    w.put('0');
  }
  (void)run_start; (void)run_len; (void)emitted_nonzero;
  w.put(']');
}

}  // namespace

extern "C" {

// Serialize one frame's residual line (entropy_encoder_frame twin).
//   qtc_full:  nb * bs * bs  int64 (row-major blocks)
//   qtc_quads: nb * 4 * sbs * sbs int64 (sbs = bs/2, Z-order quads)
//   split:     nb bytes (0 = full block, 1 = quads)
// Writes into out[0..cap); returns bytes written, or -1 on overflow.
int64_t encode_residual_line(const int64_t* qtc_full, const int64_t* qtc_quads,
                             const uint8_t* split, int64_t nb, int32_t bs,
                             int32_t numpy_repr, char* out, int64_t cap) {
  const int sbs = bs / 2;
  const std::vector<int32_t> idx_full = diag_indices(bs);
  const std::vector<int32_t> idx_sub = diag_indices(sbs);
  Writer w{out, cap};
  for (int64_t i = 0; i < nb; ++i) {
    if (i) w.put(';');
    if (split[i] == 0) {
      w.puts("0'(");
      emit_block(w, qtc_full + i * bs * bs, idx_full, numpy_repr);
      w.put(')');
    } else {
      w.puts("1'(");
      for (int q = 0; q < 4; ++q) {
        if (q) w.put(',');
        emit_block(w, qtc_quads + ((i * 4) + q) * sbs * sbs, idx_sub, numpy_repr);
      }
      w.put(')');
    }
    if (w.overflow) return -1;
  }
  return w.overflow ? -1 : w.len;
}

// Batch RLE encode: concatenated encoded lists + per-block offsets.
//   blocks: nblocks * n * n int64.  out sized >= nblocks * (2*n*n + 1).
//   offsets: nblocks + 1 entries.  Returns total encoded length.
int64_t rle_encode_blocks(const int64_t* blocks, int64_t nblocks, int32_t n,
                          int64_t* out, int64_t* offsets) {
  const std::vector<int32_t> idx = diag_indices(n);
  const int total = n * n;
  int64_t pos = 0;
  std::vector<int64_t> run_vals;
  run_vals.reserve(total);
  for (int64_t b = 0; b < nblocks; ++b) {
    offsets[b] = pos;
    const int64_t* blk = blocks + b * total;
    run_vals.clear();
    int zero_count = 0;
    for (int s = 0; s < total; ++s) {
      int64_t v = blk[idx[s]];
      if (v != 0) {
        if (run_vals.empty() && zero_count) {
          out[pos++] = zero_count;
          zero_count = 0;
        }
        run_vals.push_back(v);
      } else {
        if (!run_vals.empty()) {
          out[pos++] = -(int64_t)run_vals.size();
          for (int64_t rv : run_vals) out[pos++] = rv;
          run_vals.clear();
        }
        ++zero_count;
      }
    }
    if (!run_vals.empty()) {
      out[pos++] = -(int64_t)run_vals.size();
      for (int64_t rv : run_vals) out[pos++] = rv;
    }
    if (zero_count) out[pos++] = 0;
  }
  offsets[nblocks] = pos;
  return pos;
}

// Batch RLE decode (entropy_decoder_block twin, decoder.py:548-586).
//   data/offsets as produced above; out_blocks: nblocks * n * n int64 zeroed
//   by the callee.  Reads are bounded by each block's [offsets[b],
//   offsets[b+1]) window even for malformed run headers (a nonzero-run
//   header claiming more values than remain reads only what is there —
//   the Python twin's slice semantics), so file-derived data cannot drive
//   out-of-bounds reads; offset sanity itself is the caller's check.
void rle_decode_blocks(const int64_t* data, const int64_t* offsets,
                       int64_t nblocks, int32_t n, int64_t* out_blocks) {
  const std::vector<int32_t> idx = diag_indices(n);
  const int total = n * n;
  for (int64_t b = 0; b < nblocks; ++b) {
    int64_t* blk = out_blocks + b * total;
    std::memset(blk, 0, sizeof(int64_t) * total);
    int64_t i = offsets[b];
    const int64_t end = offsets[b + 1];
    int s = 0;
    while (i >= 0 && i < end && s < total) {
      int64_t c = data[i];
      if (c < 0) {
        // clamp the claimed run to the window (also avoids -INT64_MIN UB
        // and i overflow on adversarial headers)
        const int64_t run = c == INT64_MIN ? end - i : std::min(-c, end - i);
        for (int64_t k = 0; k < run && s < total && i + 1 + k < end; ++k)
          blk[idx[s++]] = data[i + 1 + k];
        i += run;
      } else {
        if (c == 0) break;
        s += (int)std::min<int64_t>(c, total);  // run of zeros (pre-zeroed)
      }
      ++i;
    }
  }
}

// Serialize one frame's MV line body (encode_mv_frame twin, itself the twin
// of differential_encoder_frame, Encoder.py:1419-1520) straight from the
// device-shaped arrays: mv nb*3 int32 (intra: component 0), smv nb*4*3,
// split nb bytes, qps per-row QPs (rc_active).  Replicates the exact text:
// inter tuples print as str(tuple) ("(a, b, c)"), intra split diffs join
// with bare commas, quirk K11 puts the first sub-mv diff in the row-head QP
// field of an intra split block, and a split at j==0 starts the line with
// ';' exactly like the reference.  Returns bytes written or -1 on overflow.
int64_t encode_mv_line(int32_t frame_type, int32_t rc_active,
                       int32_t blocks_per_row, int64_t nb, const int32_t* mv,
                       const int32_t* smv, const uint8_t* split,
                       const int32_t* qps, char* out, int64_t cap) {
  Writer w{out, cap};
  const int ncomp = frame_type == 0 ? 1 : 3;
  int64_t ref[3] = {0, 0, 0};
  int64_t ref_qp = 0;
  for (int64_t j = 0; j < nb; ++j) {
    const bool row_head = rc_active && (j % blocks_per_row == 0);
    const int64_t row_qp = row_head ? (int64_t)qps[j / blocks_per_row] : 0;
    if (split[j] == 0) {
      int64_t d[3];
      for (int k = 0; k < ncomp; ++k) {
        d[k] = (int64_t)mv[j * 3 + k] - ref[k];
        ref[k] = mv[j * 3 + k];
      }
      if (j) w.put(';');
      if (row_head) { w.put_int(row_qp - ref_qp); w.put('@'); }
      w.puts("0'(");
      for (int k = 0; k < ncomp; ++k) {
        if (k) w.puts(", ");
        w.put_int(d[k]);
      }
      w.put(')');
    } else {
      // the reference prepends ';' unconditionally for split blocks (so a
      // split at j==0 yields a leading ';' — kept for byte parity; real
      // streams never split border blocks)
      w.put(';');
      int64_t first_diff = 0;
      char body[512];
      Writer b{body, (int64_t)sizeof(body)};
      for (int s = 0; s < 4; ++s) {
        if (s) b.put(',');
        if (frame_type == 1) b.put('(');
        for (int k = 0; k < ncomp; ++k) {
          if (k) b.puts(", ");
          int64_t d = (int64_t)smv[(j * 4 + s) * 3 + k] - ref[k];
          ref[k] = smv[(j * 4 + s) * 3 + k];
          if (s == 0 && k == 0) first_diff = d;
          b.put_int(d);
        }
        if (frame_type == 1) b.put(')');
      }
      if (b.overflow) return -1;
      if (row_head) {
        // quirk K11: the intra "QP" field carries the first sub-mv diff;
        // inter rows carry the real QP delta
        w.put_int(frame_type == 0 ? first_diff : row_qp - ref_qp);
        w.put('@');
      }
      w.puts("1'(");
      for (int64_t t = 0; t < b.len; ++t) w.put(body[t]);
      w.put(')');
    }
    if (row_head) ref_qp = row_qp;
    if (w.overflow) return -1;
  }
  return w.len;
}

// ---------------------------------------------------------------- parsing
//
// Native twins of the bitstream TEXT parsers (decode_residual_frame /
// decode_mv_frame in streamoptima_tpu_torch/bitstream.py, themselves twins of
// decoder.py:548-670).  The grammar is Python-literal text: plain ints or
// "np.intNN(v)" scalar reprs, tuples/lists with arbitrary whitespace.  The
// parsers are STRICT: any anomaly (truncated text, wrong arity, int32/int16
// overflow, item count != nb) returns -1 and the caller falls back to the
// Python parser, which raises the same errors the list path always raised —
// so corrupt streams keep their loud behavior and well-formed streams parse
// at C speed (the Python residual parse measured ~370 ms/frame at 720p
// against ~2 ms device decode).

namespace {

struct Cursor {
  const char* p;
  const char* end;

  inline void ws() {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r')) ++p;
  }
  inline bool lit(char c) {
    ws();
    if (p < end && *p == c) { ++p; return true; }
    return false;
  }
  inline bool peek(char c) {
    ws();
    return p < end && *p == c;
  }
  inline bool done() {
    ws();
    return p >= end;
  }
  // plain integer or an np.int8/16/32/64(v) wrapper (the numpy>=2 scalar
  // repr the reference's files exhibit; bitstream.py strips it by regex)
  bool num(int64_t* out) {
    ws();
    bool wrapped = false;
    if (end - p > 8 && std::memcmp(p, "np.int", 6) == 0) {
      const char* q = p + 6;
      if (q < end && (*q == '8')) q += 1;
      else if (end - q >= 2 && ((q[0] == '1' && q[1] == '6') ||
                                (q[0] == '3' && q[1] == '2') ||
                                (q[0] == '6' && q[1] == '4'))) q += 2;
      else return false;
      if (q >= end || *q != '(') return false;
      p = q + 1;
      wrapped = true;
      ws();
    }
    bool neg = false;
    if (p < end && (*p == '-' || *p == '+')) { neg = (*p == '-'); ++p; }
    if (p >= end || *p < '0' || *p > '9') return false;
    const bool leading_zero = *p == '0';
    int64_t v = 0;
    int digits = 0;
    while (p < end && *p >= '0' && *p <= '9') {
      v = v * 10 + (*p - '0');
      if (++digits > 18) return false;  // would overflow int64 accumulation
      ++p;
    }
    // Python integer literals forbid leading zeros ("00", "-08"):
    // ast.literal_eval raises SyntaxError, so stay strict and fall back
    if (leading_zero && digits > 1) return false;
    if (wrapped && !lit(')')) return false;
    *out = neg ? -v : v;
    return true;
  }
};

// One RLE list "[...]" -> block (zeroed by caller).  Values out of int16
// range fail (the array interchange is int16; the Python path raises
// OverflowError for these).  Replicates rle_decode_block exactly: c<0 =>
// the next -c elements are values, c==0 => rest-of-block zeros (remaining
// TEXT still consumed), c>0 => c zeros; values beyond n*n are ignored.
bool parse_rle_list(Cursor& c, const std::vector<int32_t>& idx, int total,
                    int16_t* blk) {
  if (!c.lit('[')) return false;
  if (c.lit(']')) return true;  // empty list: all zeros
  int s = 0;
  int64_t pending = 0;  // nonzero-run values still expected
  bool closed = false;  // saw the trailing 0 header
  for (;;) {
    int64_t v;
    if (!c.num(&v)) return false;
    if (closed) {
      // ignored (Python breaks out of the decode loop; literal_eval already
      // consumed the text)
    } else if (pending > 0) {
      if (s < total) {
        if (v < -32768 || v > 32767) return false;
        blk[idx[s]] = (int16_t)v;
      }
      ++s;
      --pending;
    } else if (v < 0) {
      pending = -v;
    } else if (v == 0) {
      closed = true;
    } else {
      s += (int)std::min<int64_t>(v, total);  // zeros (block pre-zeroed)
    }
    if (c.lit(']')) return true;
    if (!c.lit(',')) return false;
  }
}

}  // namespace

// Parse one residual text line (decode_residual_frame twin) into
// device-shaped arrays: qf nb*bs*bs int16, qq nb*4*sbs*sbs int16 (both
// zeroed here), split nb bytes.  Returns items parsed (must equal nb for
// success — the caller compares) or -1 on any anomaly.
int64_t parse_residual_line(const char* line, int64_t len, int64_t nb,
                            int32_t bs, int16_t* qf, int16_t* qq,
                            uint8_t* split) {
  const int sbs = bs / 2;
  const std::vector<int32_t> idx_full = diag_indices(bs);
  const std::vector<int32_t> idx_sub = diag_indices(sbs);
  std::memset(qf, 0, sizeof(int16_t) * nb * bs * bs);
  std::memset(qq, 0, sizeof(int16_t) * nb * 4 * sbs * sbs);
  Cursor c{line, line + len};
  int64_t i = 0;
  while (!c.done()) {
    if (i >= nb) return -1;
    char sp;
    c.ws();
    if (c.p >= c.end) break;
    sp = *c.p++;
    if (sp != '0' && sp != '1') return -1;
    if (!c.lit('\'') || !c.lit('(')) return -1;
    if (sp == '0') {
      split[i] = 0;
      if (!parse_rle_list(c, idx_full, bs * bs, qf + i * bs * bs)) return -1;
    } else {
      split[i] = 1;
      for (int q = 0; q < 4; ++q) {
        if (q && !c.lit(',')) return -1;
        if (!parse_rle_list(c, idx_sub, sbs * sbs,
                            qq + ((i * 4) + q) * sbs * sbs))
          return -1;
      }
    }
    if (!c.lit(')')) return -1;
    ++i;
    if (c.done()) break;
    if (!c.lit(';')) return -1;
    // a trailing ';' with nothing after it is malformed (the Python parser
    // sees an empty item and raises) — stay strict so the fallback fires
    if (c.done()) return -1;
  }
  return i;
}

namespace {

inline bool in_i32(int64_t v) { return v >= INT32_MIN && v <= INT32_MAX; }

}  // namespace

// Parse one MV text line (decode_mv_frame twin, decoder.py:590-649):
// "<ft>|items".  Fills mv nb*3 int32 (intra: component 0 only), smv nb*4*3
// int32, split nb bytes, qps (row-head QPs when rc_active; qps_cap slots).
// *nqp receives the QP count.  Returns the frame type (0/1) or -1 on any
// anomaly (caller falls back to the Python parser).
int64_t parse_mv_line(const char* line, int64_t len, int32_t rc_active,
                      int32_t blocks_per_row, int64_t nb, int32_t* mv,
                      int32_t* smv, uint8_t* split, int32_t* qps,
                      int64_t qps_cap, int64_t* nqp) {
  std::memset(mv, 0, sizeof(int32_t) * nb * 3);
  std::memset(smv, 0, sizeof(int32_t) * nb * 4 * 3);
  Cursor c{line, line + len};
  int64_t ft;
  if (!c.num(&ft) || (ft != 0 && ft != 1)) return -1;
  if (!c.lit('|')) return -1;
  int64_t ref[3] = {0, 0, 0};
  int64_t ref_qp = 0;
  int64_t j = 0;
  int64_t q_n = 0;
  const int ncomp = ft == 0 ? 1 : 3;
  while (!c.done()) {
    if (j >= nb) return -1;
    if (rc_active && j % blocks_per_row == 0) {
      // row head: the field before '@' accumulates into the QP chain —
      // including quirk K11 (intra split rows put the first sub-mv diff
      // there; the decoder still treats it as the QP delta)
      int64_t dq;
      if (!c.num(&dq) || !c.lit('@')) return -1;
      ref_qp += dq;
      if (q_n >= qps_cap || !in_i32(ref_qp)) return -1;
      qps[q_n++] = (int32_t)ref_qp;
    }
    c.ws();
    if (c.p >= c.end) return -1;
    char sp = *c.p++;
    if (sp != '0' && sp != '1') return -1;
    if (!c.lit('\'') || !c.lit('(')) return -1;
    if (sp == '0') {
      split[j] = 0;
      for (int k = 0; k < ncomp; ++k) {
        if (k && !c.lit(',')) return -1;
        int64_t d;
        if (!c.num(&d)) return -1;
        ref[k] += d;
        if (!in_i32(ref[k])) return -1;
        mv[j * 3 + k] = (int32_t)ref[k];
      }
      if (ft == 1 && c.lit(',')) return -1;  // tuple arity must be 3
    } else {
      split[j] = 1;
      for (int s = 0; s < 4; ++s) {
        if (s && !c.lit(',')) return -1;
        if (ft == 1 && !c.lit('(')) return -1;
        for (int k = 0; k < ncomp; ++k) {
          if (k && !c.lit(',')) return -1;
          int64_t d;
          if (!c.num(&d)) return -1;
          ref[k] += d;
          if (!in_i32(ref[k])) return -1;
          smv[(j * 4 + s) * 3 + k] = (int32_t)ref[k];
        }
        if (ft == 1 && !c.lit(')')) return -1;
      }
    }
    if (!c.lit(')')) return -1;
    ++j;
    if (c.done()) break;
    if (!c.lit(';')) return -1;
    if (c.done()) return -1;  // trailing ';' — Python raises on the empty item
  }
  if (j != nb) return -1;
  *nqp = q_n;
  return ft;
}

}  // extern "C"
