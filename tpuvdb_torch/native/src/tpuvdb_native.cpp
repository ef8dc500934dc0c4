// Native host runtime of tpuvdb_torch: group-commit WAL writer, compact KV
// store, mmap-backed vector file, fused exact rescore.
//
// The port's own copy of tpuvdb/native/src/tpuvdb_native.cpp: the C ABI,
// the on-disk formats and the arithmetic are the reference's, so a
// docstore.kv or a mirror file written by either package reads in the other.
//   * WalWriter  — durability append path with a dedicated writer thread
//     doing group fsync (amortizes ~ms-scale fsyncs across concurrent
//     producers).
//   * KvStore    — open-addressing string->record map with binary
//     snapshot, the key->(shard,slot,meta) store without a per-op Python
//     dict overhead at 100M-key scale.
//   * VectorFile — mmap row store backing shard mirrors so checkpoints
//     are msync + hardlink instead of GB-scale npz copies.
//
// Exposed as a C ABI for ctypes (tpuvdb_torch/native/__init__.py).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

extern "C" {

// ---------------------------------------------------------------- WalWriter

struct WalWriter {
  int fd = -1;
  bool do_fsync = true;
  std::mutex mu;
  std::condition_variable cv_data;   // producer -> writer
  std::condition_variable cv_done;   // writer -> waiters
  std::vector<uint8_t> pending;
  uint64_t enqueued_seq = 0;  // bytes enqueued (ticket space)
  uint64_t durable_seq = 0;   // bytes written (+fsynced if enabled)
  bool io_error = false;      // persistent write failure (e.g. ENOSPC)
  bool stop = false;
  std::thread writer;

  void run() {
    std::vector<uint8_t> batch;
    for (;;) {
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_data.wait(lk, [&] { return stop || !pending.empty(); });
        if (pending.empty() && stop) return;
        batch.swap(pending);
      }
      size_t off = 0;
      while (off < batch.size()) {
        ssize_t w = ::write(fd, batch.data() + off, batch.size() - off);
        if (w < 0) {
          if (errno == EINTR) continue;
          // Persistent failure (ENOSPC, EIO...): flag it so wal_sync
          // returns an error instead of blocking forever on a ticket
          // whose bytes will never become durable.
          std::lock_guard<std::mutex> lk(mu);
          io_error = true;
          break;
        }
        off += static_cast<size_t>(w);
      }
      if (do_fsync) ::fsync(fd);
      {
        std::lock_guard<std::mutex> lk(mu);
        durable_seq += off;
      }
      cv_done.notify_all();  // also wakes waiters when io_error was set
      batch.clear();
    }
  }
};

void* wal_open(const char* path, int do_fsync) {
  int fd = ::open(path, O_WRONLY | O_CREAT | O_APPEND, 0644);
  if (fd < 0) return nullptr;
  auto* w = new WalWriter();
  w->fd = fd;
  w->do_fsync = do_fsync != 0;
  w->writer = std::thread([w] { w->run(); });
  return w;
}

// Enqueue a record; returns a ticket to pass to wal_sync.
uint64_t wal_append(void* h, const uint8_t* data, uint64_t len) {
  auto* w = static_cast<WalWriter*>(h);
  uint64_t ticket;
  {
    std::lock_guard<std::mutex> lk(w->mu);
    w->pending.insert(w->pending.end(), data, data + len);
    w->enqueued_seq += len;
    ticket = w->enqueued_seq;
  }
  w->cv_data.notify_one();
  return ticket;
}

// Block until the given ticket is durable. Returns 1 on success, 0 if the
// writer hit a persistent IO error or was stopped before reaching it.
int wal_sync(void* h, uint64_t ticket) {
  auto* w = static_cast<WalWriter*>(h);
  std::unique_lock<std::mutex> lk(w->mu);
  w->cv_done.wait(lk, [&] {
    return w->durable_seq >= ticket || w->io_error || w->stop;
  });
  return w->durable_seq >= ticket ? 1 : 0;
}

uint64_t wal_durable(void* h) {
  auto* w = static_cast<WalWriter*>(h);
  std::lock_guard<std::mutex> lk(w->mu);
  return w->durable_seq;
}

void wal_close(void* h) {
  auto* w = static_cast<WalWriter*>(h);
  {
    std::lock_guard<std::mutex> lk(w->mu);
    w->stop = true;
  }
  w->cv_data.notify_all();
  w->writer.join();
  // drain anything left (stop raced with producers)
  if (!w->pending.empty()) {
    size_t off = 0;
    while (off < w->pending.size()) {
      ssize_t n = ::write(w->fd, w->pending.data() + off,
                          w->pending.size() - off);
      if (n <= 0) break;
      off += static_cast<size_t>(n);
    }
    if (w->do_fsync) ::fsync(w->fd);
  }
  ::close(w->fd);
  w->cv_done.notify_all();
  delete w;
}

// ------------------------------------------------------------------ KvStore
//
// Open-addressing (linear probing) map: string key -> fixed header
// (shard, slot, timestamp) + variable value blob. Keys and blobs live in an
// arena; the table stores offsets. Tombstones are compacted on rehash.

struct KvEntry {
  uint64_t hash = 0;
  uint64_t key_off = 0;   // arena offset; 0 = empty (arena starts at 1)
  uint32_t key_len = 0;
  uint64_t val_off = 0;
  uint32_t val_len = 0;
  int32_t shard = 0;
  int64_t slot = 0;
  int64_t ts = 0;
  uint8_t state = 0;  // 0 empty, 1 used, 2 tombstone
};

// (shard, slot) -> key reverse entry: offsets into the KvStore arena.
// Kept in C++ so the search path's row->key resolution and the 100M-key
// restore never materialize a python-side slot table (the python mirror of
// this map was ~1 GB of interpreter strings at 8M keys).
struct RevEntry {
  uint64_t key_off = 0;  // 0 = empty
  uint32_t key_len = 0;
};

struct KvStore {
  std::vector<KvEntry> table;
  std::vector<uint8_t> arena;  // [0] unused so offset 0 == null
  std::vector<std::vector<RevEntry>> rev;  // [shard][slot] -> key
  std::vector<const RevEntry*> scratch_cells;  // kv_rows_keys pass-1 buffer
  uint64_t used = 0;
  uint64_t tombstones = 0;
  std::mutex mu;

  KvStore() : table(1024), arena(1) {}

  RevEntry* rev_cell(int32_t shard, int64_t slot, bool create) {
    if (shard < 0 || shard > (1 << 20) || slot < 0 || slot > (1LL << 40)) {
      return nullptr;
    }
    if (static_cast<size_t>(shard) >= rev.size()) {
      if (!create) return nullptr;
      rev.resize(shard + 1);
    }
    auto& v = rev[shard];
    if (static_cast<size_t>(slot) >= v.size()) {
      if (!create) return nullptr;
      size_t grow = v.empty() ? 1024 : v.size();
      while (grow <= static_cast<size_t>(slot)) grow *= 2;
      v.resize(grow);
    }
    return &v[slot];
  }

  // clear the reverse cell iff it currently points at this key (a later
  // put may have claimed the slot; mirrors the python DocStore semantics)
  void rev_clear_if(int32_t shard, int64_t slot, uint64_t key_off,
                    uint32_t key_len) {
    RevEntry* c = rev_cell(shard, slot, false);
    if (c && c->key_off && c->key_len == key_len &&
        memcmp(arena.data() + c->key_off, arena.data() + key_off,
               key_len) == 0) {
      c->key_off = 0;
      c->key_len = 0;
    }
  }

  static uint64_t hash_key(const uint8_t* k, uint32_t len) {
    uint64_t h = 1469598103934665603ULL;  // FNV-1a
    for (uint32_t i = 0; i < len; i++) {
      h ^= k[i];
      h *= 1099511628211ULL;
    }
    return h | 1;  // never 0
  }

  uint64_t put_blob(const uint8_t* data, uint32_t len) {
    uint64_t off = arena.size();
    arena.insert(arena.end(), data, data + len);
    return off;
  }

  bool key_equals(const KvEntry& e, const uint8_t* k, uint32_t len) const {
    return e.key_len == len &&
           memcmp(arena.data() + e.key_off, k, len) == 0;
  }

  void rehash(size_t new_cap) {
    std::vector<KvEntry> old;
    old.swap(table);
    table.assign(new_cap, KvEntry());
    tombstones = 0;
    for (auto& e : old) {
      if (e.state != 1) continue;
      size_t mask = table.size() - 1;
      size_t i = e.hash & mask;
      while (table[i].state == 1) i = (i + 1) & mask;
      table[i] = e;
    }
  }

  KvEntry* find(const uint8_t* k, uint32_t len, uint64_t h) {
    size_t mask = table.size() - 1;
    size_t i = h & mask;
    while (true) {
      KvEntry& e = table[i];
      if (e.state == 0) return nullptr;
      if (e.state == 1 && e.hash == h && key_equals(e, k, len)) return &e;
      i = (i + 1) & mask;
    }
  }
};

void* kv_create() { return new KvStore(); }
void kv_destroy(void* h) { delete static_cast<KvStore*>(h); }

// Core insert/overwrite; caller holds kv->mu. Fills prev_shard/prev_slot
// with the overwritten placement (-1/-1 when the key is new) so callers can
// soft-delete the old slot. Returns 1 on overwrite, 0 on insert.
static int kv_put_locked(KvStore* kv, const uint8_t* key, uint32_t key_len,
                         int32_t shard, int64_t slot, int64_t ts,
                         const uint8_t* val, uint32_t val_len,
                         int32_t* prev_shard, int64_t* prev_slot) {
  *prev_shard = -1;
  *prev_slot = -1;
  uint64_t hash = KvStore::hash_key(key, key_len);
  if ((kv->used + kv->tombstones + 1) * 10 >= kv->table.size() * 7) {
    kv->rehash(kv->table.size() * 2);
  }
  size_t mask = kv->table.size() - 1;
  size_t i = hash & mask;
  ssize_t first_tomb = -1;
  while (true) {
    KvEntry& e = kv->table[i];
    if (e.state == 0) break;
    if (e.state == 2 && first_tomb < 0) first_tomb = static_cast<ssize_t>(i);
    if (e.state == 1 && e.hash == hash && kv->key_equals(e, key, key_len)) {
      *prev_shard = e.shard;
      *prev_slot = e.slot;
      if (e.shard != shard || e.slot != slot) {
        kv->rev_clear_if(e.shard, e.slot, e.key_off, e.key_len);
      }
      e.shard = shard;
      e.slot = slot;
      e.ts = ts;
      e.val_off = kv->put_blob(val, val_len);
      e.val_len = val_len;
      RevEntry* c = kv->rev_cell(shard, slot, true);
      if (c) { c->key_off = e.key_off; c->key_len = e.key_len; }
      return 1;
    }
    i = (i + 1) & mask;
  }
  size_t target = first_tomb >= 0 ? static_cast<size_t>(first_tomb) : i;
  KvEntry& e = kv->table[target];
  if (e.state == 2) kv->tombstones--;
  e.hash = hash;
  e.key_off = kv->put_blob(key, key_len);
  e.key_len = key_len;
  e.val_off = kv->put_blob(val, val_len);
  e.val_len = val_len;
  e.shard = shard;
  e.slot = slot;
  e.ts = ts;
  e.state = 1;
  kv->used++;
  RevEntry* c = kv->rev_cell(shard, slot, true);
  if (c) { c->key_off = e.key_off; c->key_len = e.key_len; }
  return 0;
}

// Returns 1 if the key existed (overwrite), 0 if new.
int kv_put(void* h, const uint8_t* key, uint32_t key_len, int32_t shard,
           int64_t slot, int64_t ts, const uint8_t* val, uint32_t val_len) {
  auto* kv = static_cast<KvStore*>(h);
  std::lock_guard<std::mutex> lk(kv->mu);
  int32_t ps;
  int64_t pl;
  return kv_put_locked(kv, key, key_len, shard, slot, ts, val, val_len,
                       &ps, &pl);
}

// Bulk insert: one lock + one FFI crossing for n records (the per-key
// ctypes round trip dominated bulk ingest at ~10 us/row). keys_blob /
// vals_blob are packed concatenations sliced by key_lens / val_lens.
// prev_shards[i] = -1 when key i was new, else its previous placement.
int kv_put_many(void* h, const uint8_t* keys_blob, const uint32_t* key_lens,
                const int32_t* shards, const int64_t* slots,
                const int64_t* tss, const uint8_t* vals_blob,
                const uint32_t* val_lens, uint64_t n, int32_t* prev_shards,
                int64_t* prev_slots) {
  auto* kv = static_cast<KvStore*>(h);
  std::lock_guard<std::mutex> lk(kv->mu);
  const uint8_t* kp = keys_blob;
  const uint8_t* vp = vals_blob;
  for (uint64_t i = 0; i < n; i++) {
    kv_put_locked(kv, kp, key_lens[i], shards[i], slots[i], tss[i], vp,
                  val_lens[i], &prev_shards[i], &prev_slots[i]);
    kp += key_lens[i];
    vp += val_lens[i];
  }
  return 1;
}

// (shard, slot) -> key. Returns 1 + fills out/len, 0 if the slot maps to
// no live key, 2 if out is too small (*len holds the required size).
int kv_key_at(void* h, int32_t shard, int64_t slot, uint8_t* out,
              uint32_t cap, uint32_t* len) {
  auto* kv = static_cast<KvStore*>(h);
  std::lock_guard<std::mutex> lk(kv->mu);
  RevEntry* c = kv->rev_cell(shard, slot, false);
  if (!c || !c->key_off) return 0;
  *len = c->key_len;
  if (c->key_len > cap) return 2;
  memcpy(out, kv->arena.data() + c->key_off, c->key_len);
  return 1;
}

// Liveness bitmap: out[i] = 1 iff (shards[i], slots[i]) maps to a live key.
// The search path compacts candidates on this BEFORE materializing any
// python strings — resolving keys for dead/padded slots was pure waste.
int kv_slots_live(void* h, const int32_t* shards, const int64_t* slots,
                  uint64_t n, uint8_t* out) {
  auto* kv = static_cast<KvStore*>(h);
  std::lock_guard<std::mutex> lk(kv->mu);
  for (uint64_t i = 0; i < n; i++) {
    RevEntry* c = kv->rev_cell(shards[i], slots[i], false);
    out[i] = (c && c->key_off) ? 1 : 0;
  }
  return 1;
}

// Bulk reverse lookup for the search path's row->key resolution: keys pack
// consecutively into out, lens[i] = 0 marks unmapped slots. Returns 1, or
// 0 when out_cap is insufficient (caller doubles the buffer and retries).
int kv_keys_at(void* h, const int32_t* shards, const int64_t* slots,
               uint64_t n, uint8_t* out, uint64_t out_cap, uint32_t* lens) {
  auto* kv = static_cast<KvStore*>(h);
  std::lock_guard<std::mutex> lk(kv->mu);
  uint64_t off = 0;
  for (uint64_t i = 0; i < n; i++) {
    RevEntry* c = kv->rev_cell(shards[i], slots[i], false);
    if (!c || !c->key_off) {
      lens[i] = 0;
      continue;
    }
    if (off + c->key_len > out_cap) return 0;
    memcpy(out + off, kv->arena.data() + c->key_off, c->key_len);
    lens[i] = c->key_len;
    off += c->key_len;
  }
  return 1;
}

// Sizes for kv_export_entries buffer allocation: live entry count plus
// total key/value byte lengths.
int kv_export_sizes(void* h, uint64_t* n, uint64_t* key_bytes,
                    uint64_t* val_bytes) {
  auto* kv = static_cast<KvStore*>(h);
  std::lock_guard<std::mutex> lk(kv->mu);
  uint64_t cnt = 0, kb = 0, vb = 0;
  for (auto& e : kv->table) {
    if (e.state != 1) continue;
    cnt++;
    kb += e.key_len;
    vb += e.val_len;
  }
  *n = cnt;
  *key_bytes = kb;
  *val_bytes = vb;
  return 1;
}

// Columnar bulk export of every live entry in ONE crossing: packed key
// blob + per-entry lengths, shard/slot/ts arrays, packed value blob +
// lengths. The per-item cursor iterator (kv_next) costs ~60 us/1k entries
// of ctypes round trips — compaction snapshots a 1M-key store through
// this instead (memcpy speed, taken under the engine lock). Returns 0 if
// a buffer is too small (caller re-sizes via kv_export_sizes), else 1.
int kv_export_entries(void* h, uint8_t* keys_out, uint64_t keys_cap,
                      uint32_t* key_lens, int32_t* shards, int64_t* slots,
                      int64_t* tss, uint8_t* vals_out, uint64_t vals_cap,
                      uint32_t* val_lens, uint64_t max_n, uint64_t* n_out) {
  auto* kv = static_cast<KvStore*>(h);
  std::lock_guard<std::mutex> lk(kv->mu);
  const uint8_t* arena = kv->arena.data();
  uint64_t i = 0, koff = 0, voff = 0;
  for (auto& e : kv->table) {
    if (e.state != 1) continue;
    if (i >= max_n || koff + e.key_len > keys_cap ||
        voff + e.val_len > vals_cap) {
      return 0;
    }
    memcpy(keys_out + koff, arena + e.key_off, e.key_len);
    key_lens[i] = e.key_len;
    koff += e.key_len;
    if (e.val_len) {
      memcpy(vals_out + voff, arena + e.val_off, e.val_len);
      voff += e.val_len;
    }
    val_lens[i] = e.val_len;
    shards[i] = e.shard;
    slots[i] = e.slot;
    tss[i] = e.ts;
    i++;
  }
  *n_out = i;
  return 1;
}

// Fused liveness + bulk reverse lookup for the serving fast path: rows[]
// are FLAT global row ids (shard = row / phys_cap, slot = row % phys_cap,
// decomposed here — saves a numpy div/mod pass and a second FFI crossing
// for the liveness bitmap). lens[i] = 0 marks dead / unmapped / negative
// rows; *n_missing counts them so the caller can tell "all live" (serve
// the packed keys as-is) from "needs the compaction slow path" without
// scanning the list. Random accesses into the rev tables and the key
// arena are cache-cold at 1M+ keys, so both passes software-prefetch a
// few iterations ahead. Returns 0 when out_cap is insufficient (caller
// grows the buffer and retries), else 1.
int kv_rows_keys(void* h, const int64_t* rows, uint64_t n, int64_t phys_cap,
                 uint8_t* out, uint64_t out_cap, uint32_t* lens,
                 uint32_t* n_missing) {
  auto* kv = static_cast<KvStore*>(h);
  std::lock_guard<std::mutex> lk(kv->mu);
  if (phys_cap <= 0) return 0;
  const uint64_t D = 8;  // prefetch distance
  const size_t nsh = kv->rev.size();
  std::vector<const RevEntry*>& cells = kv->scratch_cells;
  cells.resize(n);
  // pass 1: gather RevEntry pointers, prefetching the rev cells ahead
  for (uint64_t i = 0; i < n; i++) {
    if (i + D < n) {
      int64_t r = rows[i + D];
      if (r >= 0) {
        size_t sh = static_cast<size_t>(r / phys_cap);
        size_t sl = static_cast<size_t>(r % phys_cap);
        if (sh < nsh && sl < kv->rev[sh].size())
          __builtin_prefetch(&kv->rev[sh][sl]);
      }
    }
    const RevEntry* c = nullptr;
    int64_t r = rows[i];
    if (r >= 0) {
      size_t sh = static_cast<size_t>(r / phys_cap);
      size_t sl = static_cast<size_t>(r % phys_cap);
      if (sh < nsh && sl < kv->rev[sh].size()) c = &kv->rev[sh][sl];
    }
    cells[i] = c;
  }
  // pass 2: copy key bytes, prefetching the arena reads ahead
  uint64_t off = 0;
  uint32_t miss = 0;
  const uint8_t* arena = kv->arena.data();
  for (uint64_t i = 0; i < n; i++) {
    if (i + D < n) {
      const RevEntry* cn = cells[i + D];
      if (cn && cn->key_off) __builtin_prefetch(arena + cn->key_off);
    }
    const RevEntry* c = cells[i];
    if (!c || !c->key_off) {
      lens[i] = 0;
      miss++;
      continue;
    }
    if (off + c->key_len > out_cap) return 0;
    memcpy(out + off, arena + c->key_off, c->key_len);
    lens[i] = c->key_len;
    off += c->key_len;
  }
  *n_missing = miss;
  return 1;
}

// Returns 1 + fills outputs if found; 0 if absent; 2 if found but the
// value did not fit in val_cap (*val_len holds the required size — retry
// with a larger buffer; copying nothing beats handing back stale bytes).
int kv_get(void* h, const uint8_t* key, uint32_t key_len, int32_t* shard,
           int64_t* slot, int64_t* ts, uint8_t* val, uint32_t val_cap,
           uint32_t* val_len) {
  auto* kv = static_cast<KvStore*>(h);
  std::lock_guard<std::mutex> lk(kv->mu);
  uint64_t hash = KvStore::hash_key(key, key_len);
  KvEntry* e = kv->find(key, key_len, hash);
  if (!e) return 0;
  *shard = e->shard;
  *slot = e->slot;
  *ts = e->ts;
  *val_len = e->val_len;
  if (e->val_len > val_cap) return 2;
  if (e->val_len) {
    memcpy(val, kv->arena.data() + e->val_off, e->val_len);
  }
  return 1;
}

int kv_del(void* h, const uint8_t* key, uint32_t key_len) {
  auto* kv = static_cast<KvStore*>(h);
  std::lock_guard<std::mutex> lk(kv->mu);
  uint64_t hash = KvStore::hash_key(key, key_len);
  KvEntry* e = kv->find(key, key_len, hash);
  if (!e) return 0;
  kv->rev_clear_if(e->shard, e->slot, e->key_off, e->key_len);
  e->state = 2;
  kv->used--;
  kv->tombstones++;
  return 1;
}

uint64_t kv_size(void* h) {
  auto* kv = static_cast<KvStore*>(h);
  std::lock_guard<std::mutex> lk(kv->mu);
  return kv->used;
}

// Live entries carrying a non-empty value blob (metadata). Lets a restore
// skip the O(n) python iteration that rebuilds the metadata inverted index
// when no entry has metadata at all.
uint64_t kv_nonempty_vals(void* h) {
  auto* kv = static_cast<KvStore*>(h);
  std::lock_guard<std::mutex> lk(kv->mu);
  uint64_t n = 0;
  for (auto& e : kv->table) {
    if (e.state == 1 && e.val_len > 0) n++;
  }
  return n;
}

// Cursor iteration: scan the table from `*cursor`, copy out the next used
// entry, advance cursor. Returns 1 if an entry was produced, 0 at end.
int kv_next(void* h, uint64_t* cursor, uint8_t* key, uint32_t key_cap,
            uint32_t* key_len, int32_t* shard, int64_t* slot, int64_t* ts,
            uint8_t* val, uint32_t val_cap, uint32_t* val_len) {
  auto* kv = static_cast<KvStore*>(h);
  std::lock_guard<std::mutex> lk(kv->mu);
  for (uint64_t i = *cursor; i < kv->table.size(); i++) {
    KvEntry& e = kv->table[i];
    if (e.state != 1) continue;
    *key_len = e.key_len;
    *shard = e.shard;
    *slot = e.slot;
    *ts = e.ts;
    *val_len = e.val_len;
    if (e.key_len > key_cap || e.val_len > val_cap) {
      // Buffers too small: report required sizes WITHOUT advancing the
      // cursor, so the caller can grow and re-read this same entry.
      *cursor = i;
      return 2;
    }
    if (e.key_len) memcpy(key, kv->arena.data() + e.key_off, e.key_len);
    if (e.val_len) memcpy(val, kv->arena.data() + e.val_off, e.val_len);
    *cursor = i + 1;
    return 1;
  }
  *cursor = kv->table.size();
  return 0;
}

// Binary snapshot: [u64 count] then per-entry
// [u32 klen][key][i32 shard][i64 slot][i64 ts][u32 vlen][val]
int kv_dump(void* h, const char* path) {
  auto* kv = static_cast<KvStore*>(h);
  std::lock_guard<std::mutex> lk(kv->mu);
  std::string tmp = std::string(path) + ".tmp";
  FILE* f = fopen(tmp.c_str(), "wb");
  if (!f) return 0;
  uint64_t count = kv->used;
  fwrite(&count, 8, 1, f);
  for (auto& e : kv->table) {
    if (e.state != 1) continue;
    fwrite(&e.key_len, 4, 1, f);
    fwrite(kv->arena.data() + e.key_off, 1, e.key_len, f);
    fwrite(&e.shard, 4, 1, f);
    fwrite(&e.slot, 8, 1, f);
    fwrite(&e.ts, 8, 1, f);
    fwrite(&e.val_len, 4, 1, f);
    if (e.val_len) fwrite(kv->arena.data() + e.val_off, 1, e.val_len, f);
  }
  fflush(f);
  fsync(fileno(f));
  fclose(f);
  return rename(tmp.c_str(), path) == 0 ? 1 : 0;
}

// Serialize the snapshot into a malloc'd buffer (same format as kv_dump).
// Memory-speed under the store mutex, so an engine can capture a
// consistent snapshot under its serving lock and do the disk write with
// the lock RELEASED (kv_dump holds the mutex for the whole disk write —
// seconds of serving stall at multi-GB scale). Caller frees via
// kv_buf_free.
int kv_dump_mem(void* h, uint8_t** out, uint64_t* out_len) {
  auto* kv = static_cast<KvStore*>(h);
  std::lock_guard<std::mutex> lk(kv->mu);
  uint64_t sz = 8;
  for (auto& e : kv->table) {
    if (e.state != 1) continue;
    sz += 4 + e.key_len + 4 + 8 + 8 + 4 + e.val_len;
  }
  uint8_t* buf = static_cast<uint8_t*>(malloc(sz));
  if (!buf) return 0;
  uint8_t* p = buf;
  uint64_t count = kv->used;
  memcpy(p, &count, 8); p += 8;
  for (auto& e : kv->table) {
    if (e.state != 1) continue;
    memcpy(p, &e.key_len, 4); p += 4;
    if (e.key_len) { memcpy(p, kv->arena.data() + e.key_off, e.key_len); p += e.key_len; }
    memcpy(p, &e.shard, 4); p += 4;
    memcpy(p, &e.slot, 8); p += 8;
    memcpy(p, &e.ts, 8); p += 8;
    memcpy(p, &e.val_len, 4); p += 4;
    if (e.val_len) { memcpy(p, kv->arena.data() + e.val_off, e.val_len); p += e.val_len; }
  }
  *out = buf;
  *out_len = sz;
  return 1;
}

void kv_buf_free(uint8_t* p) { free(p); }

int kv_load(void* h, const char* path) {
  auto* kv = static_cast<KvStore*>(h);
  FILE* f = fopen(path, "rb");
  if (!f) return 0;
  uint64_t count = 0;
  if (fread(&count, 8, 1, f) != 1) { fclose(f); return 0; }
  // Pre-size the table for `count` inserts BEFORE replaying the records.
  // The dump order is the donor table's slot order (sorted by
  // hash mod donor_size); reloading that sorted stream through the
  // doubling growth path folds it onto smaller intermediate tables,
  // saturating contiguous probe runs — linear probing goes QUADRATIC
  // (measured: 4.9M records took 232 s; pre-sized it is linear).
  // Clamped by file size so a corrupt count cannot balloon the alloc
  // (28 bytes = smallest possible record frame).
  {
    fseeko(f, 0, SEEK_END);
    off_t fsz = ftello(f);
    fseeko(f, 8, SEEK_SET);
    uint64_t max_recs = fsz > 8 ? static_cast<uint64_t>(fsz - 8) / 28 : 0;
    uint64_t n_exp = count < max_recs ? count : max_recs;
    std::lock_guard<std::mutex> lk(kv->mu);
    uint64_t need = 1024;
    while (need * 7 < (n_exp + kv->used + kv->tombstones + 1) * 10)
      need *= 2;
    if (need > kv->table.size()) kv->rehash(need);
  }
  std::vector<uint8_t> kbuf, vbuf;
  for (uint64_t n = 0; n < count; n++) {
    uint32_t klen = 0, vlen = 0;
    int32_t shard = 0;
    int64_t slot = 0, ts = 0;
    if (fread(&klen, 4, 1, f) != 1) break;
    kbuf.resize(klen);
    if (klen && fread(kbuf.data(), 1, klen, f) != klen) break;
    if (fread(&shard, 4, 1, f) != 1) break;
    if (fread(&slot, 8, 1, f) != 1) break;
    if (fread(&ts, 8, 1, f) != 1) break;
    if (fread(&vlen, 4, 1, f) != 1) break;
    vbuf.resize(vlen);
    if (vlen && fread(vbuf.data(), 1, vlen, f) != vlen) break;
    kv_put(h, kbuf.data(), klen, shard, slot, ts, vbuf.data(), vlen);
  }
  fclose(f);
  return 1;
}

// --------------------------------------------------------------- VectorFile

struct VectorFile {
  int fd = -1;
  uint8_t* base = nullptr;
  uint64_t rows = 0;
  uint64_t row_bytes = 0;
  uint64_t mapped = 0;
};

void* vf_open(const char* path, uint64_t rows, uint64_t row_bytes) {
  int fd = ::open(path, O_RDWR | O_CREAT, 0644);
  if (fd < 0) return nullptr;
  uint64_t size = rows * row_bytes;
  struct stat st;
  fstat(fd, &st);
  if (static_cast<uint64_t>(st.st_size) < size) {
    if (ftruncate(fd, static_cast<off_t>(size)) != 0) {
      ::close(fd);
      return nullptr;
    }
  }
  void* base = mmap(nullptr, size, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  if (base == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  auto* vf = new VectorFile();
  vf->fd = fd;
  vf->base = static_cast<uint8_t*>(base);
  vf->rows = rows;
  vf->row_bytes = row_bytes;
  vf->mapped = size;
  return vf;
}

uint8_t* vf_data(void* h) { return static_cast<VectorFile*>(h)->base; }

int vf_write(void* h, uint64_t row, const uint8_t* data) {
  auto* vf = static_cast<VectorFile*>(h);
  if (row >= vf->rows) return 0;
  memcpy(vf->base + row * vf->row_bytes, data, vf->row_bytes);
  return 1;
}

int vf_read(void* h, uint64_t row, uint8_t* out) {
  auto* vf = static_cast<VectorFile*>(h);
  if (row >= vf->rows) return 0;
  memcpy(out, vf->base + row * vf->row_bytes, vf->row_bytes);
  return 1;
}

int vf_flush(void* h) {
  auto* vf = static_cast<VectorFile*>(h);
  return msync(vf->base, vf->mapped, MS_SYNC) == 0 ? 1 : 0;
}

void vf_close(void* h) {
  auto* vf = static_cast<VectorFile*>(h);
  munmap(vf->base, vf->mapped);
  ::close(vf->fd);
  delete vf;
}

// ----------------------------------------------------- fused exact rescore
//
// Serving epilogue for the capacity tiers: re-rank device candidates by
// exact distance straight from the shard mirror's stored rows. The numpy
// path materializes every candidate as f32 (gather + dequant: a 63 MB
// transient at b32 x fetch640 x 768-d) and then re-reads it twice more
// (norm einsum + BLAS matvec) — ~250 MB of memory traffic per batch on a
// one-core host. These kernels stream each int8/f32 row through registers
// exactly once and reuse the mirror's precomputed ||v||^2, so the traffic
// drops to the 15 MB of codes actually needed.
//
//   out[opos[i]] = qsq[qi] - 2*scale[slot]*(q[qi] . vec[slot]) + sq[slot]
//   (qi = opos[i] / fetch_w; out is pre-filled with +inf by the caller so
//    missing candidates keep their sentinel)
//
// Bounds: slot/opos come from device search results; the
// engine invariant masks dead/padded candidates to -1 before this call,
// but the old kernel read out-of-bounds heap SILENTLY on a violated
// invariant where the numpy path raised IndexError. Each candidate now
// pays one compare against the mirror's physical row count (n_rows) and
// the output extent (out_n = Q * fetch_w): a bad slot with a valid opos
// writes +inf (predictable, sorts last); a bad opos is skipped.
//
// Role parity: the exact-refine stage of the reference's serving path
// (hnswlib returns approximate hits; here the int8/PQ probe overfetches
// and this restores exact order — FAISS IVFPQ "refine" in role).

__attribute__((target_clones("avx512f", "avx2", "default")))
void rescore2_rows_int8(const float* __restrict q,
                        const float* __restrict qsq,
                        int64_t d, int64_t fetch_w, int64_t n_rows,
                        int64_t out_n,
                        const int8_t* __restrict vec,
                        const float* __restrict scale,
                        const float* __restrict sq,
                        const int64_t* __restrict slots,
                        const int64_t* __restrict opos, int64_t n,
                        float* __restrict out) {
  for (int64_t i = 0; i < n; i++) {
    const int64_t slot = slots[i];
    const int64_t op = opos[i];
    if (op < 0 || op >= out_n) continue;
    if (slot < 0 || slot >= n_rows) {
      out[op] = __builtin_inff();
      continue;
    }
    if (i + 1 < n) {  // candidate rows are a random gather: hide the
      const int64_t ns = slots[i + 1];            // DRAM latency behind
      if (ns >= 0 && ns < n_rows) {               // this row's dot
        const int8_t* nx = vec + ns * d;
        for (int64_t j = 0; j < d; j += 64) __builtin_prefetch(nx + j, 0, 1);
      }
    }
    const int64_t qi = op / fetch_w;
    const int8_t* r = vec + slot * d;
    const float* qr = q + qi * d;
    float acc = 0.f;
    for (int64_t j = 0; j < d; j++) acc += qr[j] * (float)r[j];
    out[op] = qsq[qi] - 2.f * scale[slot] * acc + sq[slot];
  }
}

__attribute__((target_clones("avx512f", "avx2", "default")))
void rescore2_rows_f32(const float* __restrict q,
                       const float* __restrict qsq,
                       int64_t d, int64_t fetch_w, int64_t n_rows,
                       int64_t out_n,
                       const float* __restrict vec,
                       const float* __restrict sq,
                       const int64_t* __restrict slots,
                       const int64_t* __restrict opos, int64_t n,
                       float* __restrict out) {
  for (int64_t i = 0; i < n; i++) {
    const int64_t slot = slots[i];
    const int64_t op = opos[i];
    if (op < 0 || op >= out_n) continue;
    if (slot < 0 || slot >= n_rows) {
      out[op] = __builtin_inff();
      continue;
    }
    if (i + 1 < n) {
      const int64_t ns = slots[i + 1];
      if (ns >= 0 && ns < n_rows) {
        const float* nx = vec + ns * d;
        for (int64_t j = 0; j < d; j += 16) __builtin_prefetch(nx + j, 0, 1);
      }
    }
    const int64_t qi = op / fetch_w;
    const float* r = vec + slot * d;
    const float* qr = q + qi * d;
    float acc = 0.f;
    for (int64_t j = 0; j < d; j++) acc += qr[j] * r[j];
    out[op] = qsq[qi] - 2.f * acc + sq[slot];
  }
}

}  // extern "C"
