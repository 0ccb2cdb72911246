// Threaded prefetching record loader (shared library, ctypes ABI).
//
// The reference delegates input pipelines to TF's C++ runtime (queues /
// iterators; SURVEY.md §2.2). The TPU rebuild ships its own native
// loader: fixed-size binary records (static shapes — XLA-friendly),
// reader threads prefetching into a bounded batch queue so host IO
// overlaps device steps, and deterministic seeded shuffling + host
// sharding (record index mod num_shards) for multi-host data
// parallelism.
//
// File format (ADTR1): 8-byte magic "ADTR1\0\0\0", int64 record_size
// (bytes), int64 num_records, then num_records * record_size bytes.
//
// ABI (extern "C"):
//   void* adl_create(const char** files, int nfiles, int64 record_size,
//                    int64 batch_records, int threads, int64 seed,
//                    int shuffle, int64 shard_id, int64 num_shards,
//                    int64 queue_cap);
//   int64 adl_next(void* h, char* out);   // blocks; fills batch_records *
//                                         // record_size bytes; returns
//                                         // records written or -1 on err
//   int64 adl_epoch(void* h);             // completed epochs so far
//   void  adl_destroy(void* h);
//
// Build: g++ -O2 -std=c++17 -pthread -shared -fPIC -o dataloader.so
//        dataloader.cc

#include <algorithm>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr char kMagic[8] = {'A', 'D', 'T', 'R', '1', 0, 0, 0};

struct RecordRef {
  int file;
  int64_t offset;  // byte offset of the record in the file
};

struct Loader {
  std::vector<std::string> files;
  int64_t record_size = 0;
  int64_t batch_records = 0;
  int64_t queue_cap = 4;
  bool shuffle = false;
  int64_t seed = 0;
  int64_t shard_id = 0, num_shards = 1;

  std::vector<RecordRef> index;  // this shard's records
  std::mutex mu;
  std::condition_variable cv_put, cv_get;
  std::deque<std::vector<char>> queue;
  std::vector<std::thread> workers;
  bool stop = false;
  int64_t epoch = 0;
  int64_t error = 0;

  ~Loader() {
    {
      std::lock_guard<std::mutex> l(mu);
      stop = true;
    }
    cv_put.notify_all();
    cv_get.notify_all();
    for (auto& t : workers)
      if (t.joinable()) t.join();
  }
};

bool build_index(Loader* L) {
  int64_t global = 0;
  for (int fi = 0; fi < static_cast<int>(L->files.size()); ++fi) {
    FILE* f = fopen(L->files[fi].c_str(), "rb");
    if (!f) return false;
    char magic[8];
    int64_t rec_size = 0, n_rec = 0;
    if (fread(magic, 1, 8, f) != 8 || memcmp(magic, kMagic, 8) != 0 ||
        fread(&rec_size, 8, 1, f) != 1 || fread(&n_rec, 8, 1, f) != 1 ||
        rec_size != L->record_size) {
      fclose(f);
      return false;
    }
    for (int64_t r = 0; r < n_rec; ++r, ++global) {
      if (global % L->num_shards == L->shard_id) {
        L->index.push_back({fi, 24 + r * rec_size});
      }
    }
    fclose(f);
  }
  return !L->index.empty();
}

// Single producer thread: sequential permuted reads, batches pushed to
// the bounded queue. (One thread per loader keeps epoch/order semantics
// deterministic; parallelism comes from overlapping with device compute.
// For higher throughput, create several sharded loaders.)
void producer(Loader* L) {
  std::mt19937_64 rng(L->seed);
  std::vector<size_t> order(L->index.size());
  for (size_t i = 0; i < order.size(); ++i) order[i] = i;
  std::vector<FILE*> handles(L->files.size(), nullptr);
  size_t pos = 0;
  if (L->shuffle) std::shuffle(order.begin(), order.end(), rng);
  std::vector<char> batch;
  while (true) {
    batch.assign(L->batch_records * L->record_size, 0);
    for (int64_t b = 0; b < L->batch_records; ++b) {
      if (pos == order.size()) {
        pos = 0;
        {
          std::lock_guard<std::mutex> l(L->mu);
          ++L->epoch;
        }
        if (L->shuffle) std::shuffle(order.begin(), order.end(), rng);
      }
      const RecordRef& ref = L->index[order[pos++]];
      FILE*& f = handles[ref.file];
      if (!f) f = fopen(L->files[ref.file].c_str(), "rb");
      if (!f || fseek(f, ref.offset, SEEK_SET) != 0 ||
          fread(batch.data() + b * L->record_size, 1, L->record_size,
                f) != static_cast<size_t>(L->record_size)) {
        std::lock_guard<std::mutex> l(L->mu);
        L->error = 1;
        L->cv_get.notify_all();
        for (FILE* h : handles)
          if (h) fclose(h);
        return;
      }
    }
    std::unique_lock<std::mutex> l(L->mu);
    L->cv_put.wait(l, [L] {
      return L->stop ||
             L->queue.size() < static_cast<size_t>(L->queue_cap);
    });
    if (L->stop) break;
    L->queue.push_back(std::move(batch));
    L->cv_get.notify_one();
  }
  for (FILE* h : handles)
    if (h) fclose(h);
}

}  // namespace

extern "C" {

void* adl_create(const char** files, int nfiles, int64_t record_size,
                 int64_t batch_records, int threads, int64_t seed,
                 int shuffle, int64_t shard_id, int64_t num_shards,
                 int64_t queue_cap) {
  (void)threads;  // see producer() comment
  auto* L = new Loader();
  for (int i = 0; i < nfiles; ++i) L->files.emplace_back(files[i]);
  L->record_size = record_size;
  L->batch_records = batch_records;
  L->seed = seed;
  L->shuffle = shuffle != 0;
  L->shard_id = shard_id;
  L->num_shards = num_shards;
  L->queue_cap = queue_cap > 0 ? queue_cap : 4;
  if (!build_index(L)) {
    delete L;
    return nullptr;
  }
  L->workers.emplace_back(producer, L);
  return L;
}

int64_t adl_next(void* h, char* out) {
  auto* L = static_cast<Loader*>(h);
  std::vector<char> batch;
  {
    std::unique_lock<std::mutex> l(L->mu);
    L->cv_get.wait(l, [L] {
      return L->stop || L->error || !L->queue.empty();
    });
    if (L->error || L->stop) return -1;
    batch = std::move(L->queue.front());
    L->queue.pop_front();
    L->cv_put.notify_one();
  }
  memcpy(out, batch.data(), batch.size());
  return L->batch_records;
}

int64_t adl_epoch(void* h) {
  auto* L = static_cast<Loader*>(h);
  std::lock_guard<std::mutex> l(L->mu);
  return L->epoch;
}

void adl_destroy(void* h) { delete static_cast<Loader*>(h); }

}  // extern "C"
