// Native FASTQ/FASTA ingest — the kseq.h equivalent for multi-GB/s
// input.  The port's copy of csrc/fastq.cpp: the record scanner
// (bwamem_fastq_scan) as it was, plus the packed parse the port's
// chunk loop uses (bwamem_fastq_pack), which writes a buffer's records
// straight into columns in one pass, and the framing cut of a stream
// block (bwamem_fastq_cut).

#include <cstdint>
#include <cstring>

namespace {

// io/fasta._CODE: A C G T (either case) -> 0..3, every other byte -> 4
struct CodeTable {
  uint8_t c[256];
  CodeTable() {
    std::memset(c, 4, sizeof c);
    const char* b = "ACGT";
    for (int i = 0; i < 4; ++i) {
      c[(uint8_t)b[i]] = (uint8_t)i;
      c[(uint8_t)(b[i] + 32)] = (uint8_t)i;
    }
  }
};
const CodeTable kCode;

// the bytes Python's bytes.strip() takes off
inline bool is_space(char ch) {
  return ch == ' ' || ch == '\t' || ch == '\n' || ch == '\r' ||
         ch == '\v' || ch == '\f';
}

}  // namespace

extern "C" {

// Offsets layout per record (5 int64): name_s, name_e, seq_s, seq_e,
// qual_s (qual length == seq length; qual_s = -1 for FASTA records).
// Returns the number of records parsed (<= max_rec), or -1 on a
// malformed buffer.
int64_t bwamem_fastq_scan(const char* buf, int64_t n, int64_t max_rec,
                          int64_t* off) {
  int64_t i = 0, rec = 0;
  auto skip_eol = [&](int64_t& p) {
    while (p < n && (buf[p] == '\n' || buf[p] == '\r')) ++p;
  };
  auto find_eol = [&](int64_t p) {
    while (p < n && buf[p] != '\n' && buf[p] != '\r') ++p;
    return p;
  };
  skip_eol(i);
  while (i < n && rec < max_rec) {
    char tag = buf[i];
    if (tag != '@' && tag != '>') return -1;
    int64_t name_s = i + 1;
    int64_t name_e = name_s;
    while (name_e < n && buf[name_e] != '\n' && buf[name_e] != '\r' &&
           buf[name_e] != ' ' && buf[name_e] != '\t')
      ++name_e;
    int64_t line_e = find_eol(name_e);
    int64_t p = line_e;
    skip_eol(p);
    if (tag == '@') {
      int64_t seq_s = p;
      int64_t seq_e = find_eol(p);
      p = seq_e;
      skip_eol(p);
      if (p >= n || buf[p] != '+') return -1;
      p = find_eol(p);
      skip_eol(p);
      int64_t qual_s = p;
      int64_t qual_e = qual_s + (seq_e - seq_s);
      if (qual_e > n) return -1;
      off[rec * 5 + 0] = name_s;
      off[rec * 5 + 1] = name_e;
      off[rec * 5 + 2] = seq_s;
      off[rec * 5 + 3] = seq_e;
      off[rec * 5 + 4] = qual_s;
      ++rec;
      i = qual_e;
      skip_eol(i);
    } else {  // FASTA: sequence possibly multi-line — record spans until
              // the next header; caller strips newlines from the span
      int64_t seq_s = p;
      while (p < n && buf[p] != '>' && buf[p] != '@') {
        p = find_eol(p);
        skip_eol(p);
      }
      off[rec * 5 + 0] = name_s;
      off[rec * 5 + 1] = name_e;
      off[rec * 5 + 2] = seq_s;
      off[rec * 5 + 3] = p;
      off[rec * 5 + 4] = -1;
      ++rec;
      i = p;
    }
  }
  return rec;
}

// The framing cut of a stream block: the byte just past the last '\n'
// that closes a whole 4-line FASTQ record (0 if none does), and in
// *lines the number of '\n' before it (a multiple of 4).
int64_t bwamem_fastq_cut(const char* buf, int64_t n, int64_t* lines) {
  const char* p = buf;
  const char* end = buf + n;
  int64_t seen = 0, cut = 0, cut_lines = 0;
  while (p < end) {
    const void* nl = std::memchr(p, '\n', (size_t)(end - p));
    if (!nl) break;
    p = static_cast<const char*>(nl) + 1;
    if (++seen % 4 == 0) {
      cut = p - buf;
      cut_lines = seen;
    }
  }
  *lines = cut_lines;
  return cut;
}

// The packed parse: the records of buf[0, n) as the columns of
// io/fastq.ReadBatch, in one pass, with bwamem_fastq_scan's framing:
//   codes / seq_off    the base codes (io/fasta._CODE) of each record,
//                      a FASTA record's newlines left out;
//   names / name_off   the name (the header up to its first blank);
//   quals / qual_off   the quality line, as many bytes as the sequence
//                      (none for a FASTA record);
//   cmts / cmt_off     the comment: the header line past the name to its
//                      '\n', stripped as Python's bytes.strip() strips;
//   has_qual           1 for a FASTQ record, 0 for a FASTA one.
// Each blob holds at most n bytes; each *_off holds max_rec + 1 offsets
// from 0.  Returns the number of records, or -1 on a malformed buffer or
// one of more than max_rec records.
int64_t bwamem_fastq_pack(const char* buf, int64_t n, int64_t max_rec,
                          uint8_t* codes, int64_t* seq_off, char* names,
                          int64_t* name_off, char* quals, int64_t* qual_off,
                          char* cmts, int64_t* cmt_off, uint8_t* has_qual) {
  int64_t i = 0, rec = 0;
  int64_t nc = 0, nn = 0, nq = 0, nm = 0;  // bytes written to each blob
  auto skip_eol = [&](int64_t& p) {
    while (p < n && (buf[p] == '\n' || buf[p] == '\r')) ++p;
  };
  auto find_eol = [&](int64_t p) {
    while (p < n && buf[p] != '\n' && buf[p] != '\r') ++p;
    return p;
  };
  seq_off[0] = name_off[0] = qual_off[0] = cmt_off[0] = 0;
  skip_eol(i);
  while (i < n) {
    if (rec == max_rec) return -1;
    char tag = buf[i];
    if (tag != '@' && tag != '>') return -1;
    int64_t name_s = i + 1;
    int64_t name_e = name_s;
    while (name_e < n && buf[name_e] != '\n' && buf[name_e] != '\r' &&
           buf[name_e] != ' ' && buf[name_e] != '\t')
      ++name_e;
    std::memcpy(names + nn, buf + name_s, (size_t)(name_e - name_s));
    nn += name_e - name_s;
    // the comment runs to the header's '\n' (a lone '\r' stays in it,
    // and bytes.strip() takes it off the end)
    const void* nl = std::memchr(buf + name_e, '\n', (size_t)(n - name_e));
    int64_t cs = name_e;
    int64_t ce = nl ? static_cast<const char*>(nl) - buf : n;
    while (cs < ce && is_space(buf[cs])) ++cs;
    while (ce > cs && is_space(buf[ce - 1])) --ce;
    std::memcpy(cmts + nm, buf + cs, (size_t)(ce - cs));
    nm += ce - cs;
    int64_t p = find_eol(name_e);
    skip_eol(p);
    if (tag == '@') {
      int64_t seq_s = p;
      int64_t seq_e = find_eol(p);
      p = seq_e;
      skip_eol(p);
      if (p >= n || buf[p] != '+') return -1;
      p = find_eol(p);
      skip_eol(p);
      int64_t qual_s = p;
      int64_t len = seq_e - seq_s;
      if (qual_s + len > n) return -1;
      for (int64_t k = 0; k < len; ++k)
        codes[nc + k] = kCode.c[(uint8_t)buf[seq_s + k]];
      nc += len;
      std::memcpy(quals + nq, buf + qual_s, (size_t)len);
      nq += len;
      has_qual[rec] = 1;
      i = qual_s + len;
      skip_eol(i);
    } else {  // FASTA: the sequence runs to the next header, its
              // newlines left out
      while (p < n && buf[p] != '>' && buf[p] != '@') {
        int64_t e = find_eol(p);
        for (int64_t k = p; k < e; ++k) codes[nc++] = kCode.c[(uint8_t)buf[k]];
        p = e;
        skip_eol(p);
      }
      has_qual[rec] = 0;
      i = p;
    }
    ++rec;
    seq_off[rec] = nc;
    name_off[rec] = nn;
    qual_off[rec] = nq;
    cmt_off[rec] = nm;
  }
  return rec;
}

}  // extern "C"
