// Fast tar (ustar/GNU) indexer.
//
// The data pipeline needs one thing from the archive layer: a (name, data
// offset, size) table, built once per archive (the reference instead re-opens
// and scans the tar per sample, `data_loader_itp_bbox_super_node_onlyobj.py:246`).
// Python's tarfile walks headers with per-member object construction, which
// takes minutes on 100GB archives; this scanner reads 512-byte headers
// straight off the fd and costs seconds.
//
// Exposed C ABI (consumed via ctypes in native/__init__.py):
//   tar_index_build(path) -> opaque handle (NULL on failure)
//   tar_index_count(h)
//   tar_index_entry(h, i, &name, &offset, &size)  (name valid while h lives)
//   tar_index_free(h)
//   tar_read(path-fd helpers are unnecessary: Python preads directly)

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

#include <fcntl.h>
#include <unistd.h>

namespace {

constexpr size_t kBlock = 512;

struct Entry {
  std::string name;
  uint64_t offset;  // offset of file data
  uint64_t size;
};

struct Index {
  std::vector<Entry> entries;
};

// Parse a NUL/space-terminated octal field; supports GNU base-256 (high bit
// set in first byte) used for files >= 8 GiB.
uint64_t parse_number(const unsigned char* p, size_t n) {
  if (p[0] & 0x80) {  // base-256
    uint64_t v = p[0] & 0x7f;
    for (size_t i = 1; i < n; ++i) v = (v << 8) | p[i];
    return v;
  }
  uint64_t v = 0;
  for (size_t i = 0; i < n; ++i) {
    unsigned char c = p[i];
    if (c == ' ' || c == '\0') {
      if (v) break;
      continue;
    }
    if (c < '0' || c > '7') break;
    v = (v << 3) | (c - '0');
  }
  return v;
}

bool zero_block(const unsigned char* b) {
  for (size_t i = 0; i < kBlock; ++i)
    if (b[i]) return false;
  return true;
}

}  // namespace

extern "C" {

void* tar_index_build(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;

  auto* idx = new Index();
  uint64_t pos = 0;
  std::string pending_longname;   // GNU 'L' or PAX 'path' override
  uint64_t pending_size = 0;      // PAX 'size' override
  bool has_pending_size = false;
  int zeros = 0;

  // Read headers sequentially; skip over data with lseek.
  unsigned char hdr[kBlock];
  while (true) {
    ssize_t r = ::pread(fd, hdr, kBlock, (off_t)pos);
    if (r != (ssize_t)kBlock) break;
    if (zero_block(hdr)) {
      if (++zeros >= 2) break;
      pos += kBlock;
      continue;
    }
    zeros = 0;

    uint64_t size = parse_number(hdr + 124, 12);
    char type = (char)hdr[156];
    uint64_t data_blocks = (size + kBlock - 1) / kBlock;

    if (type == 'L') {  // GNU long name: data holds the real name
      std::vector<char> nm(size + 1, 0);
      if (::pread(fd, nm.data(), size, (off_t)(pos + kBlock)) == (ssize_t)size)
        pending_longname.assign(nm.data());
    } else if (type == 'x') {  // PAX extended header: "len key=value\n" records
      std::vector<char> rec(size + 1, 0);
      if (::pread(fd, rec.data(), size, (off_t)(pos + kBlock)) == (ssize_t)size) {
        size_t p = 0;
        while (p < size) {
          // leading decimal record length, then space
          size_t len = 0, q = p;
          while (q < size && rec[q] >= '0' && rec[q] <= '9')
            len = len * 10 + (rec[q++] - '0');
          if (q >= size || rec[q] != ' ' || len == 0 || p + len > size + 1) break;
          std::string kv(rec.data() + q + 1, rec.data() + p + len - 1);  // strip \n
          size_t eq = kv.find('=');
          if (eq != std::string::npos) {
            std::string key = kv.substr(0, eq), val = kv.substr(eq + 1);
            if (key == "path") pending_longname = val;
            if (key == "size") {
              pending_size = std::stoull(val);
              has_pending_size = true;
            }
          }
          p += len;
        }
      }
    } else if (type == '0' || type == '\0') {  // regular file
      std::string name;
      if (!pending_longname.empty()) {
        name.swap(pending_longname);
      } else {
        // ustar: prefix (345,155) + '/' + name (0,100)
        char prefix[156] = {0};
        char short_name[101] = {0};
        std::memcpy(short_name, hdr, 100);
        if (std::memcmp(hdr + 257, "ustar", 5) == 0) {
          std::memcpy(prefix, hdr + 345, 155);
        }
        if (prefix[0]) {
          name = std::string(prefix) + "/" + short_name;
        } else {
          name = short_name;
        }
      }
      if (has_pending_size) {
        size = pending_size;
        data_blocks = (size + kBlock - 1) / kBlock;
      }
      idx->entries.push_back(Entry{std::move(name), pos + kBlock, size});
      pending_longname.clear();
      has_pending_size = false;
    } else if (type != 'x' && type != 'L') {
      pending_longname.clear();
      has_pending_size = false;
    }
    pos += kBlock + data_blocks * kBlock;
  }
  ::close(fd);
  return idx;
}

int64_t tar_index_count(void* h) {
  return h ? (int64_t)static_cast<Index*>(h)->entries.size() : -1;
}

int tar_index_entry(void* h, int64_t i, const char** name, uint64_t* offset, uint64_t* size) {
  auto* idx = static_cast<Index*>(h);
  if (!idx || i < 0 || (size_t)i >= idx->entries.size()) return -1;
  const Entry& e = idx->entries[(size_t)i];
  *name = e.name.c_str();
  *offset = e.offset;
  *size = e.size;
  return 0;
}

void tar_index_free(void* h) { delete static_cast<Index*>(h); }

}  // extern "C"
