// Fast GGML weight-file index: scans record headers so Python can map the
// tensor payloads zero-copy.  Format per the reference loaders
// (the reference's main.cpp:493-501, 811-888): u32 magic 0x67676d6c, then
// records of {i32 n_dims, i32 name_len, i32 ttype, i32 ne[n_dims],
// char name[], raw data}.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <limits>
#include <string>
#include <vector>

namespace {

constexpr uint32_t kMagic = 0x67676d6c;

struct Record {
  std::string name;
  int32_t ttype = 0;
  int32_t n_dims = 0;
  int64_t ne[4] = {1, 1, 1, 1};
  int64_t offset = 0;  // byte offset of the raw payload
};

struct Index {
  std::vector<Record> records;
};

int64_t dtype_size(int32_t ttype) {
  switch (ttype) {
    case 0: return 4;   // f32
    case 1: return 2;   // f16
    case 16: return 1;  // i8
    case 24: return 4;  // i32
    default: return -1;
  }
}

}  // namespace

extern "C" {

void* ggml_index_open(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  uint32_t magic = 0;
  if (std::fread(&magic, 4, 1, f) != 1 || magic != kMagic) {
    std::fclose(f);
    return nullptr;
  }
  auto* index = new Index();
  for (;;) {
    int32_t header[3];
    if (std::fread(header, 4, 3, f) != 3) break;  // EOF
    Record rec;
    rec.n_dims = header[0];
    int32_t name_len = header[1];
    rec.ttype = header[2];
    if (rec.n_dims < 0 || rec.n_dims > 4 || name_len < 0 || name_len > 4096 ||
        dtype_size(rec.ttype) < 0) {
      delete index;
      std::fclose(f);
      return nullptr;
    }
    int64_t count = 1;
    for (int d = 0; d < rec.n_dims; ++d) {
      int32_t dim;
      if (std::fread(&dim, 4, 1, f) != 1) { delete index; std::fclose(f); return nullptr; }
      // a corrupt record with a negative dim — or positive dims whose
      // PRODUCT overflows int64 (signed-overflow UB) — would flip count
      // negative and fseek BACKWARDS below: a crafted file could loop
      // the scanner forever or emit garbage payload offsets
      if (dim < 0 ||
          (dim > 0 && count > std::numeric_limits<int64_t>::max() / dim)) {
        delete index; std::fclose(f); return nullptr;
      }
      rec.ne[d] = dim;
      count *= dim;
    }
    rec.name.resize(name_len);
    if (name_len && std::fread(rec.name.data(), 1, name_len, f) != (size_t)name_len) {
      delete index; std::fclose(f); return nullptr;
    }
    rec.offset = std::ftell(f);
    if (std::fseek(f, count * dtype_size(rec.ttype), SEEK_CUR) != 0) {
      delete index; std::fclose(f); return nullptr;
    }
    index->records.push_back(std::move(rec));
  }
  std::fclose(f);
  return index;
}

int ggml_index_count(void* handle) {
  return (int)static_cast<Index*>(handle)->records.size();
}

int ggml_index_record(void* handle, int i, char* name_out, int name_cap,
                      int32_t* ttype, int32_t* n_dims, int64_t* ne,
                      int64_t* offset) {
  auto* index = static_cast<Index*>(handle);
  if (i < 0 || i >= (int)index->records.size()) return 0;
  const Record& rec = index->records[i];
  if ((int)rec.name.size() + 1 > name_cap) return 0;
  std::memcpy(name_out, rec.name.c_str(), rec.name.size() + 1);
  *ttype = rec.ttype;
  *n_dims = rec.n_dims;
  for (int d = 0; d < 4; ++d) ne[d] = rec.ne[d];
  *offset = rec.offset;
  return 1;
}

void ggml_index_close(void* handle) { delete static_cast<Index*>(handle); }

}  // extern "C"
