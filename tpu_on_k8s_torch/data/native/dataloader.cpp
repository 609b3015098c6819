// Native host-side data pipeline for training (a copy of
// tpu_on_k8s/data/native/dataloader.cpp, which the port may not import).
//
// The host CPU must keep the card fed: batch assembly off the Python thread,
// prefetching into a bounded queue, and shard-aware deterministic shuffling,
// in C++ as a plain C-ABI shared library consumed via ctypes
// (tpu_on_k8s_torch/data/loader.py).
//
// Design:
//  * Dataset = mmap'd flat file of fixed-size records (tokenized sequences,
//    serialized examples, ...). Zero deserialization cost; the kernel's page
//    cache is the working set.
//  * Sharding is strided: host shard s of N owns records {i*N + s}. Every
//    shard sees per_shard = n/N records; the ragged tail is dropped so all
//    SPMD hosts take the same number of steps.
//  * Shuffling is a keyed Feistel permutation over [0, per_shard) with
//    cycle-walking — O(1) state, random access, bit-exact reproducible from
//    (seed, epoch) on any host and in the pure-Python fallback.
//  * Workers claim batch tickets from an atomic counter and deposit into a
//    slot ring (slot = ticket % prefetch); the consumer drains in ticket
//    order, so output order is deterministic regardless of worker count.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Dataset {
  int fd = -1;
  size_t size = 0;
  const char* data = nullptr;
  int64_t record_bytes = 0;
  int64_t n_records = 0;
};

inline uint32_t mix(uint32_t x, uint32_t key) {
  x ^= key;
  x *= 0x9E3779B1u;
  x ^= x >> 16;
  x *= 0x85EBCA77u;
  x ^= x >> 13;
  return x;
}

// Keyed Feistel permutation over [0, m) via cycle-walking on 2*half_bits.
struct Feistel {
  uint64_t m;
  uint32_t half_bits;
  uint32_t keys[4];

  Feistel(uint64_t m_, uint64_t seed, uint64_t epoch) : m(m_) {
    uint32_t bits = 1;
    while ((1ull << bits) < m_) bits++;
    half_bits = (bits + 1) / 2;
    for (uint32_t r = 0; r < 4; r++) {
      keys[r] = mix(static_cast<uint32_t>(seed ^ (seed >> 32)) + r * 0x1000193u,
                    static_cast<uint32_t>(epoch) * 0x01000193u + 0x811C9DC5u + r);
    }
  }

  uint64_t operator()(uint64_t x) const {
    if (m <= 1) return 0;
    const uint64_t mask = (1ull << half_bits) - 1;
    do {
      uint64_t left = x >> half_bits, right = x & mask;
      for (uint32_t r = 0; r < 4; r++) {
        uint64_t next = left ^ (mix(static_cast<uint32_t>(right), keys[r]) & mask);
        left = right;
        right = next;
      }
      x = (left << half_bits) | right;
    } while (x >= m);
    return x;
  }
};

struct Slot {
  std::vector<char> buf;
  int64_t ticket = -1;  // -1 = free
};

struct Loader {
  Dataset* ds = nullptr;
  int64_t batch_size = 0;
  int64_t shard = 0, num_shards = 1;
  int64_t seed = 0;
  bool shuffle = true;
  int64_t per_shard = 0;
  int64_t batches_per_epoch = 0;

  std::atomic<int64_t> next_ticket{0};
  int64_t consumer_pos = 0;
  bool stopping = false;

  std::vector<Slot> slots;
  std::mutex mu;
  std::condition_variable cv_producer, cv_consumer;
  std::vector<std::thread> workers;

  void fill(int64_t ticket, std::vector<char>* out) const {
    const int64_t epoch = ticket / batches_per_epoch;
    const int64_t batch_idx = ticket % batches_per_epoch;
    Feistel perm(per_shard, static_cast<uint64_t>(seed),
                 static_cast<uint64_t>(epoch));
    const int64_t rb = ds->record_bytes;
    for (int64_t j = 0; j < batch_size; j++) {
      int64_t local = batch_idx * batch_size + j;
      if (shuffle) local = static_cast<int64_t>(perm(static_cast<uint64_t>(local)));
      const int64_t global = local * num_shards + shard;
      std::memcpy(out->data() + j * rb, ds->data + global * rb, rb);
    }
  }

  void worker_loop() {
    const size_t cap = slots.size();
    while (true) {
      const int64_t ticket = next_ticket.fetch_add(1);
      std::vector<char> buf(static_cast<size_t>(batch_size * ds->record_bytes));
      fill(ticket, &buf);
      std::unique_lock<std::mutex> lock(mu);
      Slot& slot = slots[static_cast<size_t>(ticket) % cap];
      cv_producer.wait(lock, [&] {
        return stopping ||
               (slot.ticket == -1 &&
                ticket < consumer_pos + static_cast<int64_t>(cap));
      });
      if (stopping) return;
      slot.buf = std::move(buf);
      slot.ticket = ticket;
      cv_consumer.notify_all();
    }
  }
};

}  // namespace

extern "C" {

void* tk_open(const char* path, int64_t record_bytes) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size == 0 ||
      st.st_size % record_bytes != 0) {
    ::close(fd);
    return nullptr;
  }
  void* data = mmap(nullptr, static_cast<size_t>(st.st_size), PROT_READ,
                    MAP_PRIVATE, fd, 0);
  if (data == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  auto* ds = new Dataset();
  ds->fd = fd;
  ds->size = static_cast<size_t>(st.st_size);
  ds->data = static_cast<const char*>(data);
  ds->record_bytes = record_bytes;
  ds->n_records = st.st_size / record_bytes;
  return ds;
}

int64_t tk_num_records(void* handle) {
  return static_cast<Dataset*>(handle)->n_records;
}

void tk_close(void* handle) {
  auto* ds = static_cast<Dataset*>(handle);
  munmap(const_cast<char*>(ds->data), ds->size);
  ::close(ds->fd);
  delete ds;
}

// start_ticket resumes the deterministic stream mid-run in O(1): tickets
// are absolute (epoch = ticket / batches_per_epoch), so a checkpointed
// consumer position replays nothing and skips nothing.
void* tk_loader_start(void* dataset, int64_t batch_size, int64_t shard,
                      int64_t num_shards, int64_t seed,
                      int64_t start_ticket, int32_t shuffle,
                      int32_t num_workers, int32_t prefetch) {
  auto* ds = static_cast<Dataset*>(dataset);
  const int64_t per_shard = ds->n_records / num_shards;
  if (per_shard < batch_size || batch_size <= 0 || start_ticket < 0)
    return nullptr;
  auto* ld = new Loader();
  ld->ds = ds;
  ld->batch_size = batch_size;
  ld->shard = shard;
  ld->num_shards = num_shards;
  ld->seed = seed;
  ld->shuffle = shuffle != 0;
  ld->per_shard = per_shard;
  ld->batches_per_epoch = per_shard / batch_size;
  ld->next_ticket = start_ticket;
  ld->consumer_pos = start_ticket;
  ld->slots.resize(static_cast<size_t>(prefetch > 0 ? prefetch : 2));
  for (int32_t w = 0; w < (num_workers > 0 ? num_workers : 1); w++) {
    ld->workers.emplace_back([ld] { ld->worker_loop(); });
  }
  return ld;
}

int64_t tk_batches_per_epoch(void* loader) {
  return static_cast<Loader*>(loader)->batches_per_epoch;
}

// Blocks until the next in-order batch is ready, copies it into `out`
// (batch_size * record_bytes bytes). Returns 1 when a batch was written,
// 0 when the loader is stopping and `out` was left untouched — the caller
// must not treat the buffer as a batch in that case.
int32_t tk_next(void* loader, char* out) {
  auto* ld = static_cast<Loader*>(loader);
  const size_t cap = ld->slots.size();
  std::unique_lock<std::mutex> lock(ld->mu);
  Slot& slot = ld->slots[static_cast<size_t>(ld->consumer_pos) % cap];
  ld->cv_consumer.wait(lock, [&] {
    return ld->stopping || slot.ticket == ld->consumer_pos;
  });
  if (ld->stopping) return 0;
  std::memcpy(out, slot.buf.data(), slot.buf.size());
  slot.ticket = -1;
  ld->consumer_pos++;
  ld->cv_producer.notify_all();
  return 1;
}

void tk_loader_stop(void* loader) {
  auto* ld = static_cast<Loader*>(loader);
  {
    std::lock_guard<std::mutex> lock(ld->mu);
    ld->stopping = true;
  }
  ld->cv_producer.notify_all();
  ld->cv_consumer.notify_all();
  for (auto& t : ld->workers) t.join();
  delete ld;
}

}  // extern "C"
