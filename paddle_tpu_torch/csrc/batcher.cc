// The port's native input pipeline: multi-file threaded recordio read +
// buffered shuffle + fixed-shape batch assembly (a copy of
// native/batcher.cc with one change, in pop()). Worker threads fill a
// shuffle pool while ptru_batcher_next() memcpys samples straight into
// caller-owned (numpy) batch buffers. The caller blocks only when the
// pool is drier than one batch; ctypes releases the GIL for the
// duration of the call.
//
// The change: pop() draws over the first shuffle_buf slots of the pool,
// not over the whole pool. The pool holds between shuffle_buf and
// pool_cap samples depending on how far the producer threads have run;
// drawing over all of them made the order depend on thread timing. The
// window is always full when pop() draws (it waits for shuffle_buf
// samples, or for the last worker to finish), slots past it keep the
// order the producers pushed them in, and the draws come from one
// mt19937 seeded with the caller's seed, so with one producer thread
// (n_threads=1, or one file) the order is a function of the seed and
// the files alone.
//
// Record format: each record is the concatenation of n_fields
// fixed-size byte fields (write with paddle_tpu_torch.io.batcher
// .write_fixed — raw little-endian arrays, no per-sample npy header to
// parse).
//
// File container: the chunked recordio format of native/recordio.cc.
// This translation unit re-implements only the read path (header walk +
// zlib inflate) against the same on-disk layout.
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <deque>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <vector>

#include <zlib.h>

namespace {

constexpr char kFileMagic[8] = {'P', 'T', 'P', 'U', 'R', 'I', 'O', '1'};
constexpr uint32_t kChunkMagic = 0x7450526Au;
enum Compressor : uint32_t { kNone = 0, kGzip = 1 };

struct ChunkHeader {  // identical packed layout to recordio.cc
  uint32_t magic;
  uint32_t compressor;
  uint32_t num_records;
  uint64_t raw_len;
  uint64_t stored_len;
  uint32_t crc;  // crc32 of the stored payload, verified below (same
                 // contract as recordio.cc's Scanner)
} __attribute__((packed));

// Reads every record of one file into `out`; returns false on error.
bool read_file_records(const std::string& path,
                       std::vector<std::string>* out, std::string* err) {
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) {
    *err = "cannot open " + path;
    return false;
  }
  char magic[8];
  if (fread(magic, 1, 8, f) != 8 || memcmp(magic, kFileMagic, 8) != 0) {
    fclose(f);
    *err = path + ": not a paddle_tpu recordio file";
    return false;
  }
  ChunkHeader h;
  for (;;) {
    size_t n = fread(&h, 1, sizeof(h), f);
    if (n == 0) break;  // clean EOF
    constexpr uint64_t kMaxChunkBytes = 1ull << 32;  // same bound as
    if (n != sizeof(h) || h.magic != kChunkMagic ||   // recordio.cc
        h.stored_len > kMaxChunkBytes || h.raw_len > kMaxChunkBytes) {
      fclose(f);
      *err = path + ": corrupt chunk header";
      return false;
    }
    std::string payload(h.stored_len, '\0');
    if (fread(&payload[0], 1, h.stored_len, f) != h.stored_len) {
      fclose(f);
      *err = path + ": truncated chunk";
      return false;
    }
    uint32_t crc = crc32(0L, reinterpret_cast<const Bytef*>(payload.data()),
                         payload.size());
    if (crc != h.crc) {
      fclose(f);
      *err = path + ": chunk crc mismatch";
      return false;
    }
    std::string raw;
    if (h.compressor == kGzip) {
      raw.resize(h.raw_len);
      uLongf dst = h.raw_len;
      if (uncompress(reinterpret_cast<Bytef*>(&raw[0]), &dst,
                     reinterpret_cast<const Bytef*>(payload.data()),
                     payload.size()) != Z_OK || dst != h.raw_len) {
        fclose(f);
        *err = path + ": inflate failed";
        return false;
      }
    } else {
      raw = std::move(payload);
    }
    // raw = num_records x [u32 len][bytes]
    size_t pos = 0;
    for (uint32_t i = 0; i < h.num_records; ++i) {
      if (pos + 4 > raw.size()) {
        fclose(f);
        *err = path + ": corrupt record table";
        return false;
      }
      uint32_t len;
      memcpy(&len, raw.data() + pos, 4);
      pos += 4;
      if (pos + len > raw.size()) {
        fclose(f);
        *err = path + ": record overruns chunk";
        return false;
      }
      out->emplace_back(raw.data() + pos, len);
      pos += len;
    }
  }
  fclose(f);
  return true;
}

struct Batcher {
  std::vector<std::string> paths;
  std::vector<long> field_bytes;
  long sample_bytes = 0;
  int batch_size;
  size_t shuffle_buf;
  int drop_last;
  std::mt19937 rng;

  // pool of ready samples (shuffle reservoir lives inside it)
  std::mutex mu;
  std::condition_variable not_empty, not_full;
  std::deque<std::string> pool;
  size_t pool_cap;
  std::atomic<size_t> next_path{0};
  std::vector<std::thread> workers;
  int active_workers = 0;
  bool failed = false, closing = false;
  std::string error;

  void worker_run() {
    for (;;) {
      size_t idx = next_path.fetch_add(1);
      if (idx >= paths.size()) break;
      std::vector<std::string> recs;
      std::string err;
      if (!read_file_records(paths[idx], &recs, &err)) {
        std::lock_guard<std::mutex> l(mu);
        failed = true;
        error = err;
        not_empty.notify_all();
        return;
      }
      for (auto& r : recs) {
        if ((long)r.size() != sample_bytes) {
          std::lock_guard<std::mutex> l(mu);
          failed = true;
          error = paths[idx] + ": record of " +
                  std::to_string(r.size()) + " bytes, expected " +
                  std::to_string(sample_bytes);
          not_empty.notify_all();
          return;
        }
        std::unique_lock<std::mutex> l(mu);
        not_full.wait(l, [&] { return pool.size() < pool_cap || closing; });
        if (closing) return;
        pool.push_back(std::move(r));
        not_empty.notify_one();
      }
    }
    std::lock_guard<std::mutex> l(mu);
    if (--active_workers == 0) not_empty.notify_all();
  }

  // Pop one sample, shuffled: swap a random slot of the shuffle window
  // (the pool's first shuffle_buf slots, or all that are left once the
  // workers are done) to the front first.
  bool pop(std::string* out) {
    std::unique_lock<std::mutex> l(mu);
    not_empty.wait(l, [&] {
      return failed || active_workers == 0 ||
             pool.size() >= (shuffle_buf ? shuffle_buf : 1);
    });
    if (failed || pool.empty()) return false;
    size_t window = std::min(pool.size(), shuffle_buf);
    if (window > 1) {
      std::uniform_int_distribution<size_t> d(0, window - 1);
      std::swap(pool.front(), pool[d(rng)]);
    }
    *out = std::move(pool.front());
    pool.pop_front();
    not_full.notify_one();
    return true;
  }

  // Assemble up to batch_size samples into the caller's field buffers.
  long next(void** out_ptrs) {
    std::string rec;
    long got = 0;
    for (; got < batch_size; ++got) {
      if (!pop(&rec)) break;
      const char* src = rec.data();
      for (size_t f = 0; f < field_bytes.size(); ++f) {
        memcpy(static_cast<char*>(out_ptrs[f]) + got * field_bytes[f],
               src, field_bytes[f]);
        src += field_bytes[f];
      }
    }
    {
      std::lock_guard<std::mutex> l(mu);
      if (failed) return -1;
    }
    if (got == 0) return 0;
    if (drop_last && got < batch_size) return 0;
    return got;
  }

  void close() {
    {
      std::lock_guard<std::mutex> l(mu);
      closing = true;
      not_full.notify_all();
      not_empty.notify_all();
    }
    for (auto& w : workers)
      if (w.joinable()) w.join();
  }
};

}  // namespace

extern "C" {

void* ptru_batcher_open(const char** paths, int n_paths,
                        const long* field_bytes, int n_fields,
                        int batch_size, long shuffle_buf,
                        unsigned long seed, int n_threads,
                        int drop_last) {
  if (n_paths <= 0 || n_fields <= 0 || batch_size <= 0) return nullptr;
  auto* b = new Batcher;
  b->paths.assign(paths, paths + n_paths);
  b->field_bytes.assign(field_bytes, field_bytes + n_fields);
  for (long fb : b->field_bytes) b->sample_bytes += fb;
  b->batch_size = batch_size;
  b->shuffle_buf = shuffle_buf > 0 ? (size_t)shuffle_buf : 0;
  b->pool_cap = std::max<size_t>(b->shuffle_buf * 2,
                                 (size_t)batch_size * 4);
  b->drop_last = drop_last;
  b->rng.seed(seed);
  int threads = std::max(1, std::min(n_threads, n_paths));
  b->active_workers = threads;
  for (int i = 0; i < threads; ++i)
    b->workers.emplace_back(&Batcher::worker_run, b);
  return b;
}

long ptru_batcher_next(void* h, void** out_ptrs) {
  return static_cast<Batcher*>(h)->next(out_ptrs);
}

const char* ptru_batcher_error(void* h) {
  return static_cast<Batcher*>(h)->error.c_str();
}

void ptru_batcher_close(void* h) {
  auto* b = static_cast<Batcher*>(h);
  b->close();
  delete b;
}

}  // extern "C"
