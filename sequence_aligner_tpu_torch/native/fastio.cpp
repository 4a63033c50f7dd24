// Native IO hot paths of sequence_aligner_tpu_torch: the host-side IO
// around the device compute path, copied from the JAX package's
// native/fastio.cpp so the two engines read and write the same bytes.
//   * FASTA/.seq parsing straight into 2-bit base-code buffers
//     (semantics of src/BioLibs.scala:26-50: leading '>' required, headers
//     discarded, bodies concatenated, ordinal ids).  A record starts at a
//     '>' that begins a line ('\n' before it); a body drops every '\n' and
//     '\r' and keeps any other byte, which encodes as code 0 unless it is
//     one of ACGTacgt.
//   * AMOS {OVL} message formatting (src/ObjectStore.scala:127-135)
//
// Exposed as a C ABI consumed via ctypes (native/__init__.py), built with
// g++ by _build.load_host.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct MappedFile {
  const char* data = nullptr;
  size_t size = 0;
  int fd = -1;
  bool ok() const { return data != nullptr; }
  explicit MappedFile(const char* path) {
    fd = open(path, O_RDONLY);
    if (fd < 0) return;
    struct stat st;
    if (fstat(fd, &st) != 0 || st.st_size == 0) return;
    void* p = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
    if (p == MAP_FAILED) return;
    data = static_cast<const char*>(p);
    size = st.st_size;
  }
  ~MappedFile() {
    if (data) munmap(const_cast<char*>(data), size);
    if (fd >= 0) close(fd);
  }
};

// 2-bit base codes matching the reference seqHash packing
// (src/ObjectStore.scala:56-59): A=0 C=1 T=2 G=3; unknown chars -> 0.
int8_t kCode[256];
struct CodeInit {
  CodeInit() {
    memset(kCode, 0, sizeof(kCode));
    kCode[static_cast<unsigned char>('A')] = 0;
    kCode[static_cast<unsigned char>('a')] = 0;
    kCode[static_cast<unsigned char>('C')] = 1;
    kCode[static_cast<unsigned char>('c')] = 1;
    kCode[static_cast<unsigned char>('T')] = 2;
    kCode[static_cast<unsigned char>('t')] = 2;
    kCode[static_cast<unsigned char>('G')] = 3;
    kCode[static_cast<unsigned char>('g')] = 3;
  }
} code_init;

}  // namespace

extern "C" {

// Pass 1: count records and the maximum body length.
// Returns 0 on success, -1 file error, -2 invalid format.
int fasta_scan(const char* path, int64_t* n_reads, int64_t* max_len) {
  MappedFile f(path);
  if (!f.ok()) return -1;
  if (f.data[0] != '>') return -2;
  int64_t n = 0, cur = 0, mx = 0;
  bool in_header = false;
  for (size_t i = 0; i < f.size; ++i) {
    char c = f.data[i];
    if (c == '>' && (i == 0 || f.data[i - 1] == '\n')) {
      if (n > 0 && cur > mx) mx = cur;
      cur = 0;
      ++n;
      in_header = true;
    } else if (c == '\n') {
      in_header = false;
    } else if (!in_header && c != '\r') {
      ++cur;
    }
  }
  if (cur > mx) mx = cur;
  *n_reads = n;
  *max_len = mx;
  return 0;
}

// Pass 2: fill base-code matrix [n, lmax] (zero-padded, caller-zeroed or
// not — we zero the tail) and lengths [n].  Returns records filled.
int64_t fasta_encode(const char* path, int8_t* bases, int32_t* lengths,
                     int64_t n, int64_t lmax) {
  MappedFile f(path);
  if (!f.ok() || f.data[0] != '>') return -1;
  int64_t rec = -1;
  int64_t cur = 0;
  bool in_header = false;
  for (size_t i = 0; i < f.size; ++i) {
    char c = f.data[i];
    if (c == '>' && (i == 0 || f.data[i - 1] == '\n')) {
      if (rec >= 0) {
        lengths[rec] = static_cast<int32_t>(cur);
        for (int64_t j = cur; j < lmax; ++j) bases[rec * lmax + j] = 0;
      }
      ++rec;
      cur = 0;
      in_header = true;
      if (rec >= n) return -2;
    } else if (c == '\n') {
      in_header = false;
    } else if (!in_header && c != '\r') {
      if (cur < lmax && rec >= 0)
        bases[rec * lmax + cur] = kCode[static_cast<unsigned char>(c)];
      ++cur;
    }
  }
  if (rec >= 0) {
    lengths[rec] = static_cast<int32_t>(cur);
    for (int64_t j = cur; j < lmax; ++j) bases[rec * lmax + j] = 0;
  }
  return rec + 1;
}

// Chunked pass 2 for the streamed input pipeline: starting at byte
// offset *off (0 or a value this function returned — always a record
// start), encode up to max_reads records into bases [max_reads, lmax] /
// lengths, advance *off to the next unread record (or file size), and
// return the number of records encoded (0 = end of file, -1 = error).
// Host memory stays O(max_reads * lmax) regardless of file size; the
// mmap window rides the page cache across calls.
int64_t fasta_encode_chunk(const char* path, int64_t* off, int8_t* bases,
                           int32_t* lengths, int64_t max_reads,
                           int64_t lmax) {
  MappedFile f(path);
  if (!f.ok()) return -1;
  size_t i = static_cast<size_t>(*off);
  if (i >= f.size) {
    *off = static_cast<int64_t>(f.size);
    return 0;
  }
  if (f.data[i] != '>') return -1;
  int64_t rec = -1;
  int64_t cur = 0;
  bool in_header = false;
  char prev = '\n';
  for (; i < f.size; ++i) {
    char c = f.data[i];
    if (c == '>' && prev == '\n') {
      if (rec >= 0) {
        lengths[rec] = static_cast<int32_t>(cur);
        for (int64_t j = cur; j < lmax; ++j) bases[rec * lmax + j] = 0;
      }
      if (rec + 1 == max_reads) {
        *off = static_cast<int64_t>(i);
        return max_reads;
      }
      ++rec;
      cur = 0;
      in_header = true;
    } else if (c == '\n') {
      in_header = false;
    } else if (!in_header && c != '\r') {
      if (cur < lmax && rec >= 0)
        bases[rec * lmax + cur] = kCode[static_cast<unsigned char>(c)];
      ++cur;
    }
    prev = c;
  }
  if (rec >= 0) {
    lengths[rec] = static_cast<int32_t>(cur);
    for (int64_t j = cur; j < lmax; ++j) bases[rec * lmax + j] = 0;
  }
  *off = static_cast<int64_t>(f.size);
  return rec + 1;
}

// Render n {OVL} records (src/ObjectStore.scala:127-135 text shape) into
// the file at path.  Returns bytes written or -1.
int64_t ovl_write(const char* path, const int32_t* ida, const int32_t* idb,
                  const int32_t* ahg, const int32_t* bhg, int64_t n) {
  FILE* out = fopen(path, "wb");
  if (!out) return -1;
  std::vector<char> buf;
  buf.reserve(1 << 22);
  char tmp[96];
  for (int64_t i = 0; i < n; ++i) {
    int len = snprintf(tmp, sizeof(tmp),
                       "{OVL\nadj:N\nrds:%d,%d\nscr:0\nahg:%d\nbhg:%d\n}\n",
                       ida[i], idb[i], ahg[i], bhg[i]);
    buf.insert(buf.end(), tmp, tmp + len);
    if (buf.size() > (1 << 21)) {
      fwrite(buf.data(), 1, buf.size(), out);
      buf.clear();
    }
  }
  if (!buf.empty()) fwrite(buf.data(), 1, buf.size(), out);
  int64_t total = ftell(out);
  fclose(out);
  return total;
}

}  // extern "C"
