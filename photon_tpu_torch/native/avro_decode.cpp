// Copy of photon_tpu/native/avro_decode.cpp (byte for byte below this line; the port builds it into build/torch_native/).
// Columnar Avro block decoder — the native ingest accelerator.
//
// Role: the reference's data plane decodes Avro rows on executor JVMs
// (photon-client data/avro/AvroDataReader.scala) with the Java Avro runtime;
// SURVEY.md §2.9 names "Avro column decode acceleration" as sanctioned
// native scope for the TPU rebuild. This module turns DECOMPRESSED Avro
// block bytes into columnar buffers (numeric columns, interned string
// columns, feature-bag CSR triples, metadata triplets) so the Python side
// never walks records field-by-field. String interning happens here, so the
// host work left in Python is a vectorized unique-key lookup.
//
// Written from the public Avro 1.x binary spec (zigzag varints,
// little-endian IEEE doubles, block-encoded arrays/maps). Not derived from
// any existing decoder.
//
// Schema support is a compact per-field program compiled by the Python
// caller (photon_tpu/io/columnar.py) from the container file's writer
// schema:
//   0 = double
//   1 = union [null, double]           (null → NaN)
//   2 = string                         (interned id)
//   3 = union [null, string]           (null → -1)
//   4 = array<record{string name, string term, double value}>  (feature bag)
//   5 = union [null, map<string>]      (metadata triplets)
//   6 = map<string>
//   7 = float
//   8 = int/long
// Anything else → the caller falls back to the pure-Python codec.
//
// Build: g++ -O2 -std=c++17 -shared -fPIC -o libavro_decode.so avro_decode.cpp

#include <cmath>
#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Reader {
  const uint8_t* p;
  const uint8_t* end;
  bool ok = true;

  int64_t read_long() {
    uint64_t acc = 0;
    int shift = 0;
    while (p < end) {
      uint8_t b = *p++;
      acc |= static_cast<uint64_t>(b & 0x7f) << shift;
      if (!(b & 0x80)) {
        // zigzag decode
        return static_cast<int64_t>((acc >> 1) ^ (~(acc & 1) + 1));
      }
      shift += 7;
      if (shift > 63) break;
    }
    ok = false;
    return 0;
  }

  double read_double() {
    if (end - p < 8) { ok = false; return 0.0; }
    double v;
    std::memcpy(&v, p, 8);
    p += 8;
    return v;
  }

  float read_float() {
    if (end - p < 4) { ok = false; return 0.0f; }
    float v;
    std::memcpy(&v, p, 4);
    p += 4;
    return v;
  }

  bool read_str(const char** s, int64_t* len) {
    int64_t n = read_long();
    if (!ok || n < 0 || end - p < n) { ok = false; return false; }
    *s = reinterpret_cast<const char*>(p);
    *len = n;
    p += n;
    return true;
  }

  void skip_bytes(int64_t n) {
    if (n < 0 || end - p < n) { ok = false; return; }
    p += n;
  }
};

struct Interner {
  // id-by-string; blob keeps the bytes, offsets delimit them.
  std::unordered_map<std::string, int32_t> ids;
  std::vector<char> blob;
  std::vector<int64_t> offsets{0};

  int32_t intern(const char* s, int64_t len) {
    std::string key(s, static_cast<size_t>(len));
    auto it = ids.find(key);
    if (it != ids.end()) return it->second;
    int32_t id = static_cast<int32_t>(ids.size());
    ids.emplace(std::move(key), id);
    blob.insert(blob.end(), s, s + len);
    offsets.push_back(static_cast<int64_t>(blob.size()));
    return id;
  }

  int32_t intern_key(const char* name, int64_t nlen, const char* term,
                     int64_t tlen) {
    // Feature key = name when the term is empty, else name + '\x01' + term
    // (IndexMap.key convention).
    if (tlen == 0) return intern(name, nlen);
    std::string key;
    key.reserve(static_cast<size_t>(nlen + 1 + tlen));
    key.append(name, static_cast<size_t>(nlen));
    key.push_back('\x01');
    key.append(term, static_cast<size_t>(tlen));
    auto it = ids.find(key);
    if (it != ids.end()) return it->second;
    int32_t id = static_cast<int32_t>(ids.size());
    blob.insert(blob.end(), key.data(), key.data() + key.size());
    offsets.push_back(static_cast<int64_t>(blob.size()));
    ids.emplace(std::move(key), id);
    return id;
  }
};

struct Ctx {
  std::vector<uint8_t> program;
  int64_t n_records = 0;
  // Per-field outputs, indexed by field position (empty where unused).
  std::vector<std::vector<double>> numeric;
  // Exact int64 values for long fields (op 8) — doubles lose precision
  // past 2^53, which would corrupt 64-bit entity ids.
  std::vector<std::vector<int64_t>> longcol;
  std::vector<std::vector<int32_t>> strcol;
  std::vector<std::vector<int64_t>> bag_offsets;  // CSR, length n+1 per bag
  std::vector<std::vector<int32_t>> bag_keys;
  std::vector<std::vector<double>> bag_values;
  // metadata triplets across all map fields
  std::vector<int32_t> meta_rows, meta_keys, meta_vals;
  Interner intern;
};

bool decode_record(Ctx* c, Reader& r) {
  const int64_t row = c->n_records;
  for (size_t fi = 0; fi < c->program.size(); ++fi) {
    switch (c->program[fi]) {
      case 0:  // double
        c->numeric[fi].push_back(r.read_double());
        break;
      case 1: {  // union [null, double]
        int64_t tag = r.read_long();
        // A tag outside {0,1} means corrupt or schema-evolved input; treating
        // it as null would desync the stream — fail so the caller falls back
        // to the pure-Python codec.
        if (tag != 0 && tag != 1) return false;
        c->numeric[fi].push_back(tag == 1 ? r.read_double()
                                          : std::nan(""));
        break;
      }
      case 2: {  // string
        const char* s; int64_t n;
        if (!r.read_str(&s, &n)) return false;
        c->strcol[fi].push_back(c->intern.intern(s, n));
        break;
      }
      case 3: {  // union [null, string]
        int64_t tag = r.read_long();
        if (tag != 0 && tag != 1) return false;
        if (tag == 1) {
          const char* s; int64_t n;
          if (!r.read_str(&s, &n)) return false;
          c->strcol[fi].push_back(c->intern.intern(s, n));
        } else {
          c->strcol[fi].push_back(-1);
        }
        break;
      }
      case 4: {  // array<{string name, string term, double value}>
        for (;;) {
          int64_t cnt = r.read_long();
          if (!r.ok) return false;
          if (cnt == 0) break;
          if (cnt < 0) {  // block with byte size prefix
            cnt = -cnt;
            (void)r.read_long();  // block byte size — unused
          }
          for (int64_t i = 0; i < cnt; ++i) {
            const char *nm, *tm; int64_t nl, tl;
            if (!r.read_str(&nm, &nl)) return false;
            if (!r.read_str(&tm, &tl)) return false;
            double v = r.read_double();
            c->bag_keys[fi].push_back(c->intern.intern_key(nm, nl, tm, tl));
            c->bag_values[fi].push_back(v);
          }
        }
        c->bag_offsets[fi].push_back(
            static_cast<int64_t>(c->bag_keys[fi].size()));
        break;
      }
      case 5: {  // union [null, map<string>]
        int64_t tag = r.read_long();
        if (tag != 0 && tag != 1) return false;
        if (tag != 1) break;
        [[fallthrough]];
      }
      case 6: {  // map<string>
        for (;;) {
          int64_t cnt = r.read_long();
          if (!r.ok) return false;
          if (cnt == 0) break;
          if (cnt < 0) {
            cnt = -cnt;
            (void)r.read_long();
          }
          for (int64_t i = 0; i < cnt; ++i) {
            const char *k, *v; int64_t kl, vl;
            if (!r.read_str(&k, &kl)) return false;
            if (!r.read_str(&v, &vl)) return false;
            c->meta_rows.push_back(static_cast<int32_t>(row));
            c->meta_keys.push_back(c->intern.intern(k, kl));
            c->meta_vals.push_back(c->intern.intern(v, vl));
          }
        }
        break;
      }
      case 7:  // float
        c->numeric[fi].push_back(static_cast<double>(r.read_float()));
        break;
      case 8: {  // int/long
        int64_t v = r.read_long();
        c->numeric[fi].push_back(static_cast<double>(v));
        c->longcol[fi].push_back(v);
        break;
      }
      default:
        return false;
    }
    if (!r.ok) return false;
  }
  c->n_records++;
  return true;
}

}  // namespace

extern "C" {

Ctx* avro_dec_new(const uint8_t* program, int n_fields) {
  Ctx* c = new Ctx();
  c->program.assign(program, program + n_fields);
  c->numeric.resize(n_fields);
  c->longcol.resize(n_fields);
  c->strcol.resize(n_fields);
  c->bag_offsets.resize(n_fields);
  c->bag_keys.resize(n_fields);
  c->bag_values.resize(n_fields);
  for (int i = 0; i < n_fields; ++i) {
    if (c->program[i] == 4) c->bag_offsets[i].push_back(0);
  }
  return c;
}

// Decode `count` records from decompressed block bytes. Returns 0 on
// success, nonzero on malformed input (caller falls back to Python codec).
int avro_dec_block(Ctx* c, const uint8_t* data, int64_t size, int64_t count) {
  Reader r{data, data + size};
  for (int64_t i = 0; i < count; ++i) {
    if (!decode_record(c, r)) return 1;
  }
  return r.p == r.end ? 0 : 2;  // trailing bytes = schema mismatch
}

int64_t avro_dec_num_records(Ctx* c) { return c->n_records; }

const double* avro_dec_numeric(Ctx* c, int fi) { return c->numeric[fi].data(); }
const int64_t* avro_dec_longcol(Ctx* c, int fi) { return c->longcol[fi].data(); }
const int32_t* avro_dec_strcol(Ctx* c, int fi) { return c->strcol[fi].data(); }

int64_t avro_dec_bag_len(Ctx* c, int fi) {
  return static_cast<int64_t>(c->bag_keys[fi].size());
}
const int64_t* avro_dec_bag_offsets(Ctx* c, int fi) {
  return c->bag_offsets[fi].data();
}
const int32_t* avro_dec_bag_keys(Ctx* c, int fi) {
  return c->bag_keys[fi].data();
}
const double* avro_dec_bag_values(Ctx* c, int fi) {
  return c->bag_values[fi].data();
}

int64_t avro_dec_meta_len(Ctx* c) {
  return static_cast<int64_t>(c->meta_rows.size());
}
const int32_t* avro_dec_meta_rows(Ctx* c) { return c->meta_rows.data(); }
const int32_t* avro_dec_meta_keys(Ctx* c) { return c->meta_keys.data(); }
const int32_t* avro_dec_meta_vals(Ctx* c) { return c->meta_vals.data(); }

int64_t avro_dec_intern_count(Ctx* c) {
  return static_cast<int64_t>(c->intern.ids.size());
}
int64_t avro_dec_intern_blob_len(Ctx* c) {
  return static_cast<int64_t>(c->intern.blob.size());
}
const char* avro_dec_intern_blob(Ctx* c) { return c->intern.blob.data(); }
const int64_t* avro_dec_intern_offsets(Ctx* c) {
  return c->intern.offsets.data();
}

void avro_dec_free(Ctx* c) { delete c; }

}  // extern "C"
