// Copy of photon_tpu/native/index_store.cpp (byte for byte below this line; the port builds it into build/torch_native/).
// Native memory-mapped feature index store.
//
// Role parity: the reference's PalDB off-heap partitioned feature index
// (photon-api index/PalDBIndexMap.scala:43-240): hash-partitioned
// string→int and int→string stores, memory-mapped read-only so many
// processes share one page-cache copy and feature-name spaces too large
// for the host heap stay off-heap. This is an original format (not PalDB):
//
//   part-<i>.bin : [u32 magic][u32 n_entries]
//                  n × {u64 hash, u32 value, u32 key_off, u32 key_len}
//                  (sorted by hash)  ++  keys blob
//   reverse.bin  : [u32 magic][u32 total] total × {u32 part, u32 slot}
//
// Lookups: FNV-1a 64 hash → binary search in the partition given by
// hash % num_partitions → verify key bytes. C ABI for ctypes.

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint32_t kMagic = 0x50494458;  // "PIDX"

// Packed to match the builder's 20-byte on-disk layout exactly (no padding).
struct __attribute__((packed)) Entry {
  uint64_t hash;
  uint32_t value;
  uint32_t key_off;
  uint32_t key_len;
};
static_assert(sizeof(Entry) == 20, "on-disk entry layout");

struct Part {
  const uint8_t* base = nullptr;
  size_t size = 0;
  const Entry* entries = nullptr;
  uint32_t n = 0;
  const char* keys = nullptr;
};

struct RevEntry {
  uint32_t part;
  uint32_t slot;
};

struct Store {
  std::vector<Part> parts;
  const uint8_t* rev_base = nullptr;
  size_t rev_size = 0;
  const RevEntry* rev = nullptr;
  uint32_t total = 0;
};

uint64_t fnv1a64(const char* data, size_t len) {
  uint64_t h = 1469598103934665603ULL;
  for (size_t i = 0; i < len; ++i) {
    h ^= static_cast<uint8_t>(data[i]);
    h *= 1099511628211ULL;
  }
  return h;
}

const uint8_t* map_file(const std::string& path, size_t* size_out) {
  int fd = ::open(path.c_str(), O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    ::close(fd);
    return nullptr;
  }
  void* p = ::mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, fd, 0);
  ::close(fd);
  if (p == MAP_FAILED) return nullptr;
  *size_out = static_cast<size_t>(st.st_size);
  return static_cast<const uint8_t*>(p);
}

}  // namespace

extern "C" {

// Opens a store directory with n partitions. Returns an opaque handle or
// nullptr on failure.
void* pidx_open(const char* dir, int num_partitions) {
  auto* s = new Store();
  s->parts.resize(num_partitions);
  for (int i = 0; i < num_partitions; ++i) {
    std::string path = std::string(dir) + "/part-" + std::to_string(i) + ".bin";
    Part& p = s->parts[i];
    p.base = map_file(path, &p.size);
    if (!p.base || p.size < 8 ||
        *reinterpret_cast<const uint32_t*>(p.base) != kMagic) {
      delete s;
      return nullptr;
    }
    p.n = *reinterpret_cast<const uint32_t*>(p.base + 4);
    p.entries = reinterpret_cast<const Entry*>(p.base + 8);
    p.keys = reinterpret_cast<const char*>(p.base + 8 + p.n * sizeof(Entry));
  }
  std::string rev_path = std::string(dir) + "/reverse.bin";
  s->rev_base = map_file(rev_path, &s->rev_size);
  if (s->rev_base && s->rev_size >= 8 &&
      *reinterpret_cast<const uint32_t*>(s->rev_base) == kMagic) {
    s->total = *reinterpret_cast<const uint32_t*>(s->rev_base + 4);
    s->rev = reinterpret_cast<const RevEntry*>(s->rev_base + 8);
  }
  return s;
}

void pidx_close(void* handle) {
  auto* s = static_cast<Store*>(handle);
  if (!s) return;
  for (auto& p : s->parts) {
    if (p.base) ::munmap(const_cast<uint8_t*>(p.base), p.size);
  }
  if (s->rev_base) ::munmap(const_cast<uint8_t*>(s->rev_base), s->rev_size);
  delete s;
}

// name → index; -1 when absent (reference IndexMap.getIndex semantics).
int64_t pidx_get_index(void* handle, const char* key, int64_t key_len) {
  auto* s = static_cast<Store*>(handle);
  uint64_t h = fnv1a64(key, key_len);
  const Part& p = s->parts[h % s->parts.size()];
  uint32_t lo = 0, hi = p.n;
  while (lo < hi) {  // lower_bound on hash
    uint32_t mid = (lo + hi) / 2;
    if (p.entries[mid].hash < h) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  for (uint32_t i = lo; i < p.n && p.entries[i].hash == h; ++i) {
    const Entry& e = p.entries[i];
    if (e.key_len == key_len && memcmp(p.keys + e.key_off, key, key_len) == 0) {
      return e.value;
    }
  }
  return -1;
}

// Batched lookup: keys given as a packed blob + offsets; writes values.
void pidx_get_indices(void* handle, const char* blob, const int64_t* offsets,
                      int64_t n, int64_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    out[i] = pidx_get_index(handle, blob + offsets[i],
                            offsets[i + 1] - offsets[i]);
  }
}

// index → name; returns length, writes pointer into *ptr. -1 when absent.
int64_t pidx_get_name(void* handle, int64_t index, const char** ptr) {
  auto* s = static_cast<Store*>(handle);
  if (!s->rev || index < 0 || index >= s->total) return -1;
  RevEntry r = s->rev[index];
  if (r.part >= s->parts.size()) return -1;
  const Part& p = s->parts[r.part];
  if (r.slot >= p.n) return -1;
  const Entry& e = p.entries[r.slot];
  *ptr = p.keys + e.key_off;
  return e.key_len;
}

int64_t pidx_size(void* handle) {
  auto* s = static_cast<Store*>(handle);
  if (s->rev) return s->total;
  int64_t n = 0;
  for (auto& p : s->parts) n += p.n;
  return n;
}

}  // extern "C"
