// ThreadSanitizer harness for the port's native tar indexer
// (structured_alignment_vqa_tpu_torch/native/tar_index.cpp): the Python tiers
// are GIL-bound, but this C++ tier is driven from a thread pool, so it gets a
// TSAN gate.
//
// Build & run:  python -m structured_alignment_vqa_tpu_torch.native.tsan
// (the binary goes to build/ at the root of the checkout; the fixture tar to
// the path given as the first argument, else $TMPDIR/tsan_fixture.tar).
//
// Exercises the production access pattern: one shared index handle, many
// threads reading entries and pread()ing member payloads concurrently.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <unistd.h>

extern "C" {
void* tar_index_build(const char* path);
int64_t tar_index_count(void* h);
int tar_index_entry(void* h, int64_t i, const char** name, uint64_t* offset, uint64_t* size);
void tar_index_free(void* h);
}

static void write_fixture_tar(const char* path, int members) {
  // minimal ustar writer: N small members
  FILE* f = fopen(path, "wb");
  char block[512];
  for (int i = 0; i < members; ++i) {
    std::memset(block, 0, sizeof(block));
    std::snprintf(block, 100, "member_%05d.bin", i);
    std::snprintf(block + 100, 8, "%07o", 0644);
    std::snprintf(block + 108, 8, "%07o", 0);
    std::snprintf(block + 116, 8, "%07o", 0);
    std::snprintf(block + 124, 12, "%011o", 64);  // size
    std::snprintf(block + 136, 12, "%011o", 0);
    block[156] = '0';
    std::memcpy(block + 257, "ustar\0" "00", 8);
    std::memset(block + 148, ' ', 8);
    unsigned sum = 0;
    for (unsigned char c : block) sum += c;
    std::snprintf(block + 148, 8, "%06o", sum);
    fwrite(block, 1, 512, f);
    char data[512];
    std::memset(data, 'a' + (i % 26), sizeof(data));
    fwrite(data, 1, 512, f);  // 64 bytes payload + padding
  }
  std::memset(block, 0, sizeof(block));
  fwrite(block, 1, 512, f);
  fwrite(block, 1, 512, f);
  fclose(f);
}

int main(int argc, char** argv) {
  std::string fixture;
  if (argc > 1) {
    fixture = argv[1];
  } else {
    const char* tmp = std::getenv("TMPDIR");
    fixture = std::string(tmp && *tmp ? tmp : "/tmp") + "/tsan_fixture.tar";
  }
  const char* path = fixture.c_str();
  const int kMembers = 500;
  write_fixture_tar(path, kMembers);

  void* idx = tar_index_build(path);
  if (!idx || tar_index_count(idx) != kMembers) {
    std::fprintf(stderr, "index build failed\n");
    return 1;
  }

  int fd = ::open(path, O_RDONLY);
  std::atomic<long> total{0};
  std::vector<std::thread> threads;
  for (int t = 0; t < 8; ++t) {
    threads.emplace_back([&, t] {
      char buf[512];
      for (int r = 0; r < 2000; ++r) {
        int64_t i = (t * 7919 + r) % kMembers;
        const char* name;
        uint64_t off, size;
        if (tar_index_entry(idx, i, &name, &off, &size) != 0) std::abort();
        ssize_t n = ::pread(fd, buf, size, (off_t)off);
        if (n != (ssize_t)size) std::abort();
        total.fetch_add(buf[0], std::memory_order_relaxed);
      }
    });
  }
  for (auto& th : threads) th.join();
  ::close(fd);
  tar_index_free(idx);
  std::printf("tsan harness OK (checksum %ld)\n", total.load());
  return 0;
}
