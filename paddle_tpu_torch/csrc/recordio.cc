// paddle_tpu native recordio: chunked record file format + threaded
// prefetch loader.
//
// Capability parity with the reference's paddle/fluid/recordio
// (chunk.cc/header.cc/scanner.cc/writer.cc): append-only record files
// written in CRC-checked chunks with optional compression, sequential
// scan, and sharded reads. Re-designed for a TPU host loop: the loader
// runs a background thread that decodes chunks into a bounded queue so
// record IO overlaps device steps (the reference reads synchronously
// under the executor; here host IO must hide behind XLA dispatch).
//
// File layout:
//   8-byte magic "PTPURIO1"
//   chunks: [u32 kChunkMagic][u32 compressor][u32 num_records]
//           [u64 raw_len][u64 stored_len][u32 crc32-of-stored-bytes]
//           stored_len payload bytes
//   payload (after decompression): repeated [u32 len][len bytes]
//
// C API (ctypes-friendly, no C++ types across the boundary); every
// function is thread-compatible; one handle must not be shared across
// threads without external locking (the loader is internally threaded).

#include <zlib.h>

#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr char kFileMagic[8] = {'P', 'T', 'P', 'U', 'R', 'I', 'O', '1'};
constexpr uint32_t kChunkMagic = 0x7450526Au;

enum Compressor : uint32_t { kNone = 0, kGzip = 1 };

thread_local std::string g_error;

void set_error(const std::string& msg) { g_error = msg; }

uint32_t crc32_of(const void* data, size_t len) {
  return static_cast<uint32_t>(
      ::crc32(0L, static_cast<const Bytef*>(data), static_cast<uInt>(len)));
}

bool deflate_buf(const std::string& in, std::string* out) {
  uLongf bound = compressBound(in.size());
  out->resize(bound);
  if (compress2(reinterpret_cast<Bytef*>(&(*out)[0]), &bound,
                reinterpret_cast<const Bytef*>(in.data()), in.size(),
                Z_DEFAULT_COMPRESSION) != Z_OK)
    return false;
  out->resize(bound);
  return true;
}

bool inflate_buf(const std::string& in, size_t raw_len, std::string* out) {
  out->resize(raw_len);
  uLongf dest_len = raw_len;
  if (uncompress(reinterpret_cast<Bytef*>(&(*out)[0]), &dest_len,
                 reinterpret_cast<const Bytef*>(in.data()),
                 in.size()) != Z_OK)
    return false;
  return dest_len == raw_len;
}

struct ChunkHeader {
  uint32_t magic;
  uint32_t compressor;
  uint32_t num_records;
  uint64_t raw_len;
  uint64_t stored_len;
  uint32_t crc;
} __attribute__((packed));

// ---------------------------------------------------------------- writer
struct Writer {
  FILE* f = nullptr;
  uint32_t compressor = kNone;
  uint32_t max_chunk_records = 1000;
  uint64_t max_chunk_bytes = 1u << 20;
  std::string payload;
  uint32_t n_records = 0;

  bool flush_chunk() {
    if (n_records == 0) return true;
    std::string stored;
    const std::string* body = &payload;
    if (compressor == kGzip) {
      if (!deflate_buf(payload, &stored)) {
        set_error("deflate failed");
        return false;
      }
      body = &stored;
    }
    ChunkHeader h{kChunkMagic, compressor, n_records, payload.size(),
                  body->size(), crc32_of(body->data(), body->size())};
    if (fwrite(&h, sizeof h, 1, f) != 1 ||
        fwrite(body->data(), 1, body->size(), f) != body->size()) {
      set_error("short write");
      return false;
    }
    payload.clear();
    n_records = 0;
    return true;
  }
};

// --------------------------------------------------------------- scanner
struct Scanner {
  FILE* f = nullptr;
  std::string chunk;       // decoded payload of current chunk
  size_t pos = 0;          // cursor into chunk
  uint32_t remaining = 0;  // records left in chunk
  std::string record;      // last record handed out

  // returns: 1 ok, 0 eof, -1 error
  int next_chunk() {
    ChunkHeader h;
    size_t got = fread(&h, 1, sizeof h, f);
    if (got == 0) return 0;
    if (got != sizeof h || h.magic != kChunkMagic) {
      set_error("bad chunk header");
      return -1;
    }
    // sanity-bound the length fields before allocating so corrupted
    // headers raise a clean error instead of throwing bad_alloc across
    // the extern "C" boundary
    constexpr uint64_t kMaxChunkBytes = 1ull << 32;
    if (h.stored_len > kMaxChunkBytes || h.raw_len > kMaxChunkBytes) {
      set_error("corrupt chunk header (implausible length)");
      return -1;
    }
    std::string stored(h.stored_len, '\0');
    if (fread(&stored[0], 1, h.stored_len, f) != h.stored_len) {
      set_error("truncated chunk");
      return -1;
    }
    if (crc32_of(stored.data(), stored.size()) != h.crc) {
      set_error("chunk crc mismatch");
      return -1;
    }
    if (h.compressor == kGzip) {
      if (!inflate_buf(stored, h.raw_len, &chunk)) {
        set_error("inflate failed");
        return -1;
      }
    } else {
      chunk = std::move(stored);
    }
    pos = 0;
    remaining = h.num_records;
    return 1;
  }

  // returns record length, -1 on EOF, -2 on error
  long next(const void** data) {
    while (remaining == 0) {
      int rc = next_chunk();
      if (rc == 0) return -1;
      if (rc < 0) return -2;
    }
    if (pos + 4 > chunk.size()) {
      set_error("corrupt chunk payload");
      return -2;
    }
    uint32_t len;
    memcpy(&len, chunk.data() + pos, 4);
    pos += 4;
    if (pos + len > chunk.size()) {
      set_error("corrupt record length");
      return -2;
    }
    record.assign(chunk, pos, len);
    pos += len;
    --remaining;
    *data = record.data();
    return static_cast<long>(len);
  }
};

bool check_file_magic(FILE* f) {
  char magic[8];
  if (fread(magic, 1, 8, f) != 8 || memcmp(magic, kFileMagic, 8) != 0) {
    set_error("not a paddle_tpu recordio file");
    return false;
  }
  return true;
}

// ---------------------------------------------------------------- loader
// Background thread scans records (applying shard stride/offset) into a
// bounded queue; consumers pop blocking. End of stream -> empty marker.
struct Loader {
  std::unique_ptr<Scanner> scanner;
  std::thread worker;
  std::mutex mu;
  std::condition_variable not_empty, not_full;
  std::deque<std::string*> queue;
  size_t capacity = 64;
  int stride = 1, offset = 0;
  bool done = false, failed = false, closing = false;
  std::string error;  // worker-thread failure message (g_error is
                      // thread_local, invisible to the consumer thread)

  void run() {
    long idx = -1;
    const void* data = nullptr;
    for (;;) {
      long len = scanner->next(&data);
      if (len == -2) {
        std::lock_guard<std::mutex> l(mu);
        error = g_error;
        failed = true;
        done = true;
        not_empty.notify_all();
        return;
      }
      if (len == -1) break;
      ++idx;
      if (stride > 1 && (idx % stride) != offset) continue;
      auto* rec = new std::string(static_cast<const char*>(data), len);
      std::unique_lock<std::mutex> l(mu);
      not_full.wait(l, [&] { return queue.size() < capacity || closing; });
      if (closing) {
        delete rec;
        return;
      }
      queue.push_back(rec);
      not_empty.notify_one();
    }
    std::lock_guard<std::mutex> l(mu);
    done = true;
    not_empty.notify_all();
  }

  // returns length, -1 clean end, -2 error; *handle must be freed with
  // ptru_record_free
  long next(void** handle, const void** data) {
    std::unique_lock<std::mutex> l(mu);
    not_empty.wait(l, [&] { return !queue.empty() || done; });
    if (queue.empty()) return failed ? -2 : -1;
    std::string* rec = queue.front();
    queue.pop_front();
    not_full.notify_one();
    *handle = rec;
    *data = rec->data();
    return static_cast<long>(rec->size());
  }
};

}  // namespace

extern "C" {

const char* ptru_last_error() { return g_error.c_str(); }

// writer ---------------------------------------------------------------
void* ptru_writer_open(const char* path, int max_chunk_records,
                       int compressor) {
  FILE* f = fopen(path, "wb");
  if (!f) {
    set_error(std::string("cannot open for write: ") + path);
    return nullptr;
  }
  if (fwrite(kFileMagic, 1, 8, f) != 8) {
    set_error("short write of file magic");
    fclose(f);
    return nullptr;
  }
  auto* w = new Writer;
  w->f = f;
  if (max_chunk_records > 0) w->max_chunk_records = max_chunk_records;
  w->compressor = compressor == 1 ? kGzip : kNone;
  return w;
}

int ptru_writer_write(void* handle, const void* data, uint64_t len) {
  auto* w = static_cast<Writer*>(handle);
  if (len > UINT32_MAX) {
    set_error("record too large (>4GiB)");
    return -1;
  }
  uint32_t len32 = static_cast<uint32_t>(len);
  w->payload.append(reinterpret_cast<const char*>(&len32), 4);
  w->payload.append(static_cast<const char*>(data), len);
  w->n_records++;
  if (w->n_records >= w->max_chunk_records ||
      w->payload.size() >= w->max_chunk_bytes)
    return w->flush_chunk() ? 0 : -1;
  return 0;
}

int ptru_writer_close(void* handle) {
  auto* w = static_cast<Writer*>(handle);
  bool ok = w->flush_chunk();
  ok = fclose(w->f) == 0 && ok;
  delete w;
  return ok ? 0 : -1;
}

// scanner --------------------------------------------------------------
void* ptru_scanner_open(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) {
    set_error(std::string("cannot open: ") + path);
    return nullptr;
  }
  if (!check_file_magic(f)) {
    fclose(f);
    return nullptr;
  }
  auto* s = new Scanner;
  s->f = f;
  return s;
}

long ptru_scanner_next(void* handle, const void** data) {
  return static_cast<Scanner*>(handle)->next(data);
}

void ptru_scanner_close(void* handle) {
  auto* s = static_cast<Scanner*>(handle);
  fclose(s->f);
  delete s;
}

// loader ---------------------------------------------------------------
void* ptru_loader_open(const char* path, int capacity, int stride,
                       int offset) {
  FILE* f = fopen(path, "rb");
  if (!f) {
    set_error(std::string("cannot open: ") + path);
    return nullptr;
  }
  if (!check_file_magic(f)) {
    fclose(f);
    return nullptr;
  }
  auto* l = new Loader;
  l->scanner.reset(new Scanner);
  l->scanner->f = f;
  if (capacity > 0) l->capacity = capacity;
  l->stride = stride > 1 ? stride : 1;
  l->offset = offset > 0 ? offset % l->stride : 0;
  l->worker = std::thread([l] { l->run(); });
  return l;
}

long ptru_loader_next(void* handle, void** rec_handle, const void** data) {
  return static_cast<Loader*>(handle)->next(rec_handle, data);
}

const char* ptru_loader_error(void* handle) {
  auto* l = static_cast<Loader*>(handle);
  std::lock_guard<std::mutex> lk(l->mu);
  g_error = l->error;  // copy into this thread's slot so the pointer
                       // stays valid after the lock is released
  return g_error.c_str();
}

void ptru_record_free(void* rec_handle) {
  delete static_cast<std::string*>(rec_handle);
}

void ptru_loader_close(void* handle) {
  auto* l = static_cast<Loader*>(handle);
  {
    std::lock_guard<std::mutex> lk(l->mu);
    l->closing = true;
    l->not_full.notify_all();
  }
  if (l->worker.joinable()) l->worker.join();
  for (auto* rec : l->queue) delete rec;
  fclose(l->scanner->f);
  delete l;
}

}  // extern "C"
