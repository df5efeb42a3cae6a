// Shared-memory object store: the plasma equivalent for the TPU-native runtime.
//
// Reference behavior mirrored (not code): src/ray/object_manager/plasma/ —
// an immutable object store in shared memory with create→seal lifecycle,
// per-object refcounts, and LRU eviction of unreferenced sealed objects
// (ref: object_lifecycle_manager.h, eviction_policy.h). Differences by design:
// instead of a store server process + unix-socket client protocol with fd
// passing (ref: store.h, fling.cc), the allocator and object table live *in*
// the shared mapping guarded by a process-shared robust mutex, so every
// worker allocates/looks up directly with no RPC. This removes the socket
// round-trip from the put/get hot path entirely.
//
// Layout of the shared mapping:
//   [StoreHeader | slot table | heap]
// Free heap blocks form an offset-sorted singly-linked free list with
// coalescing on free (dlmalloc in the reference; first-fit is adequate since
// large-object memcpy dominates allocation cost).
//
// Build: g++ -O2 -shared -fPIC -o _shm_store.so _shm_store.cc -lpthread -lrt

#include <cstdint>
#include <cstring>
#include <cerrno>
#include <ctime>

#include <fcntl.h>
#include <pthread.h>
#include <sched.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x5250554153544f52ULL;  // "RPUASTOR"
constexpr uint32_t kIdLen = 16;
constexpr uint64_t kAlign = 64;

// Slot states. TOMBSTONE keeps open-addressing probe chains intact after
// eviction/delete; inserts reuse tombstones.
enum : uint32_t { SLOT_EMPTY = 0, SLOT_CREATED = 1, SLOT_SEALED = 2, SLOT_TOMBSTONE = 3 };

struct Slot {
  uint8_t id[kIdLen];
  uint32_t state;
  uint32_t _pad;
  uint64_t data_offset;  // offset of payload in mapping
  uint64_t data_size;
  int64_t refcount;
  // LRU doubly-linked list of evictable (sealed, refcount==0) slots.
  // Values are slot_index + 1; 0 means "none".
  uint64_t lru_prev;
  uint64_t lru_next;
};

struct FreeBlock {
  uint64_t size;         // bytes including this header
  uint64_t next_offset;  // offset of next free block, 0 = end
};

struct StoreHeader {
  uint64_t magic;
  uint64_t mapping_size;
  uint64_t heap_offset;
  uint64_t heap_size;
  uint32_t table_slots;  // power of two
  uint32_t _pad;
  uint64_t free_head;        // offset of first free block (0 = none)
  uint64_t bytes_in_use;     // allocated payload bytes
  uint64_t num_objects;
  uint64_t lru_head;         // slot_index + 1
  uint64_t lru_tail;
  uint64_t evictions;
  pthread_mutex_t mutex;
  pthread_cond_t seal_cond;
};

struct Store {
  uint8_t* base;
  uint64_t size;
  StoreHeader* hdr;
  Slot* slots;
};

inline uint64_t align_up(uint64_t v) { return (v + kAlign - 1) & ~(kAlign - 1); }

inline uint64_t id_hash(const uint8_t* id) {
  uint64_t h;
  memcpy(&h, id, 8);
  uint64_t h2;
  memcpy(&h2, id + 8, 8);
  h ^= h2 * 0x9e3779b97f4a7c15ULL;
  h ^= h >> 33;
  h *= 0xff51afd7ed558ccdULL;
  h ^= h >> 33;
  return h;
}

void lock(Store* s) {
  int rc = pthread_mutex_lock(&s->hdr->mutex);
  if (rc == EOWNERDEAD) {
    // A worker died holding the lock; the table may be mid-update but all
    // our critical sections leave it structurally consistent at each store.
    pthread_mutex_consistent(&s->hdr->mutex);
  }
}

void unlock(Store* s) { pthread_mutex_unlock(&s->hdr->mutex); }

// Lookup an existing (created/sealed) entry; nullptr if absent.
Slot* find_slot(Store* s, const uint8_t* id, bool /*unused*/ = false) {
  uint32_t mask = s->hdr->table_slots - 1;
  uint64_t idx = id_hash(id) & mask;
  for (uint32_t probe = 0; probe <= mask; ++probe, idx = (idx + 1) & mask) {
    Slot* slot = &s->slots[idx];
    if (slot->state == SLOT_EMPTY) return nullptr;
    if (slot->state != SLOT_TOMBSTONE && memcmp(slot->id, id, kIdLen) == 0)
      return slot;
  }
  return nullptr;
}

// Find a slot to insert `id` into, reusing tombstones. Returns nullptr if the
// id already exists or the table is full.
Slot* find_insert_slot(Store* s, const uint8_t* id) {
  uint32_t mask = s->hdr->table_slots - 1;
  uint64_t idx = id_hash(id) & mask;
  Slot* reusable = nullptr;
  for (uint32_t probe = 0; probe <= mask; ++probe, idx = (idx + 1) & mask) {
    Slot* slot = &s->slots[idx];
    if (slot->state == SLOT_EMPTY) return reusable ? reusable : slot;
    if (slot->state == SLOT_TOMBSTONE) {
      if (!reusable) reusable = slot;
    } else if (memcmp(slot->id, id, kIdLen) == 0) {
      return nullptr;  // duplicate
    }
  }
  return reusable;
}

inline uint64_t slot_index(Store* s, Slot* slot) {
  return static_cast<uint64_t>(slot - s->slots);
}

void lru_unlink(Store* s, Slot* slot) {
  uint64_t me = slot_index(s, slot) + 1;
  StoreHeader* h = s->hdr;
  if (slot->lru_prev)
    s->slots[slot->lru_prev - 1].lru_next = slot->lru_next;
  else if (h->lru_head == me)
    h->lru_head = slot->lru_next;
  if (slot->lru_next)
    s->slots[slot->lru_next - 1].lru_prev = slot->lru_prev;
  else if (h->lru_tail == me)
    h->lru_tail = slot->lru_prev;
  slot->lru_prev = slot->lru_next = 0;
}

void lru_push_back(Store* s, Slot* slot) {
  uint64_t me = slot_index(s, slot) + 1;
  StoreHeader* h = s->hdr;
  slot->lru_prev = h->lru_tail;
  slot->lru_next = 0;
  if (h->lru_tail)
    s->slots[h->lru_tail - 1].lru_next = me;
  else
    h->lru_head = me;
  h->lru_tail = me;
}

// Free-list insert with coalescing; list kept sorted by offset.
void heap_free(Store* s, uint64_t offset, uint64_t size) {
  StoreHeader* h = s->hdr;
  uint64_t prev = 0, cur = h->free_head;
  while (cur && cur < offset) {
    prev = cur;
    cur = reinterpret_cast<FreeBlock*>(s->base + cur)->next_offset;
  }
  FreeBlock* nb = reinterpret_cast<FreeBlock*>(s->base + offset);
  nb->size = size;
  nb->next_offset = cur;
  if (prev) {
    FreeBlock* pb = reinterpret_cast<FreeBlock*>(s->base + prev);
    pb->next_offset = offset;
    if (prev + pb->size == offset) {  // merge prev+new
      pb->size += nb->size;
      pb->next_offset = nb->next_offset;
      nb = pb;
      offset = prev;
    }
  } else {
    h->free_head = offset;
  }
  if (cur && offset + nb->size == cur) {  // merge new+next
    FreeBlock* cb = reinterpret_cast<FreeBlock*>(s->base + cur);
    nb->size += cb->size;
    nb->next_offset = cb->next_offset;
  }
}

// First-fit allocation. Returns payload offset or 0 on failure.
uint64_t heap_alloc(Store* s, uint64_t payload) {
  uint64_t need = align_up(payload);
  StoreHeader* h = s->hdr;
  uint64_t prev = 0, cur = h->free_head;
  while (cur) {
    FreeBlock* b = reinterpret_cast<FreeBlock*>(s->base + cur);
    if (b->size >= need) {
      uint64_t remaining = b->size - need;
      if (remaining >= kAlign) {
        // Split: keep remainder as a free block at the tail.
        uint64_t rem_off = cur + need;
        FreeBlock* rb = reinterpret_cast<FreeBlock*>(s->base + rem_off);
        rb->size = remaining;
        rb->next_offset = b->next_offset;
        if (prev)
          reinterpret_cast<FreeBlock*>(s->base + prev)->next_offset = rem_off;
        else
          h->free_head = rem_off;
      } else {
        need = b->size;  // absorb the sliver
        if (prev)
          reinterpret_cast<FreeBlock*>(s->base + prev)->next_offset = b->next_offset;
        else
          h->free_head = b->next_offset;
      }
      h->bytes_in_use += need;
      return cur;
    }
    prev = cur;
    cur = b->next_offset;
  }
  return 0;
}

// Evict one LRU object. Caller holds lock. Returns false if nothing evictable.
bool evict_one(Store* s) {
  StoreHeader* h = s->hdr;
  if (!h->lru_head) return false;
  Slot* victim = &s->slots[h->lru_head - 1];
  lru_unlink(s, victim);
  heap_free(s, victim->data_offset, align_up(victim->data_size));
  h->bytes_in_use -= align_up(victim->data_size);
  h->num_objects--;
  h->evictions++;
  victim->state = SLOT_TOMBSTONE;
  return true;
}

void timespec_in(struct timespec* ts, int timeout_ms) {
  clock_gettime(CLOCK_REALTIME, ts);
  ts->tv_sec += timeout_ms / 1000;
  ts->tv_nsec += static_cast<long>(timeout_ms % 1000) * 1000000L;
  if (ts->tv_nsec >= 1000000000L) {
    ts->tv_sec += 1;
    ts->tv_nsec -= 1000000000L;
  }
}

}  // namespace

extern "C" {

// Create a new store backed by shm file `name` with ~`capacity` heap bytes.
// Returns opaque handle or null.
void* rtpu_store_create(const char* name, uint64_t capacity, uint32_t table_slots) {
  if (table_slots == 0) table_slots = 1 << 16;
  // round to power of two
  uint32_t ts = 1;
  while (ts < table_slots) ts <<= 1;
  table_slots = ts;

  uint64_t header = align_up(sizeof(StoreHeader));
  uint64_t table = align_up(sizeof(Slot) * table_slots);
  uint64_t heap = align_up(capacity);
  uint64_t total = header + table + heap;

  shm_unlink(name);
  int fd = shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) return nullptr;
  if (ftruncate(fd, static_cast<off_t>(total)) != 0) {
    close(fd);
    shm_unlink(name);
    return nullptr;
  }
  void* base = mmap(nullptr, total, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (base == MAP_FAILED) {
    shm_unlink(name);
    return nullptr;
  }

  auto* hdr = static_cast<StoreHeader*>(base);
  memset(hdr, 0, sizeof(StoreHeader));
  hdr->mapping_size = total;
  hdr->heap_offset = header + table;
  hdr->heap_size = heap;
  hdr->table_slots = table_slots;

  pthread_mutexattr_t mattr;
  pthread_mutexattr_init(&mattr);
  pthread_mutexattr_setpshared(&mattr, PTHREAD_PROCESS_SHARED);
  pthread_mutexattr_setrobust(&mattr, PTHREAD_MUTEX_ROBUST);
  pthread_mutex_init(&hdr->mutex, &mattr);
  pthread_condattr_t cattr;
  pthread_condattr_init(&cattr);
  pthread_condattr_setpshared(&cattr, PTHREAD_PROCESS_SHARED);
  pthread_cond_init(&hdr->seal_cond, &cattr);

  memset(static_cast<uint8_t*>(base) + header, 0, table);

  // One big free block spanning the heap.
  auto* fb = reinterpret_cast<FreeBlock*>(static_cast<uint8_t*>(base) + hdr->heap_offset);
  fb->size = heap;
  fb->next_offset = 0;
  hdr->free_head = hdr->heap_offset;

  hdr->magic = kMagic;  // publish last

  // NOTE on first-touch cost: tmpfs pages are zero-filled on first write,
  // so the first put into a fresh region runs at page-fault speed; the
  // first-fit allocator reuses freed (already-faulted) blocks from the start
  // of the heap, so steady-state puts run at memcpy speed. A background
  // prefault thread was measured to hurt on small-core hosts (it competes
  // with the put for the same core); callers that want eager population can
  // use rtpu_store_prefault().

  Store* s = new Store();
  s->base = static_cast<uint8_t*>(base);
  s->size = total;
  s->hdr = hdr;
  s->slots = reinterpret_cast<Slot*>(s->base + header);
  return s;
}

void* rtpu_store_connect(const char* name) {
  int fd = shm_open(name, O_RDWR, 0600);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return nullptr;
  }
  void* base = mmap(nullptr, static_cast<size_t>(st.st_size), PROT_READ | PROT_WRITE,
                    MAP_SHARED, fd, 0);
  close(fd);
  if (base == MAP_FAILED) return nullptr;
  auto* hdr = static_cast<StoreHeader*>(base);
  if (hdr->magic != kMagic) {
    munmap(base, static_cast<size_t>(st.st_size));
    return nullptr;
  }
  Store* s = new Store();
  s->base = static_cast<uint8_t*>(base);
  s->size = static_cast<uint64_t>(st.st_size);
  s->hdr = hdr;
  s->slots = reinterpret_cast<Slot*>(s->base + align_up(sizeof(StoreHeader)));
  return s;
}

void rtpu_store_close(void* handle) {
  // Intentionally do NOT munmap: user code may still hold zero-copy numpy
  // views into the mapping (the same hazard exists with plasma in the
  // reference). The mapping is reclaimed at process exit; the backing file
  // is freed once the creator unlinks it and all mappings are gone.
  auto* s = static_cast<Store*>(handle);
  delete s;
}

// Eagerly populate the heap (MADV_POPULATE_WRITE is content-preserving and
// safe concurrently with puts). Blocking; call from a spare thread.
void rtpu_store_prefault(void* handle) {
#ifndef MADV_POPULATE_WRITE
#define MADV_POPULATE_WRITE 23
#endif
  auto* s = static_cast<Store*>(handle);
  uint8_t* p = s->base + s->hdr->heap_offset;
  uint64_t len = s->hdr->heap_size;
  // madvise requires a page-aligned address; heap_offset is only 64B-aligned.
  uintptr_t addr = reinterpret_cast<uintptr_t>(p);
  uintptr_t aligned = addr & ~static_cast<uintptr_t>(4095);
  len += addr - aligned;
  if (madvise(reinterpret_cast<void*>(aligned), len, MADV_POPULATE_WRITE) != 0) {
    // Fallback (old kernels / EINVAL): touch one byte per page with an
    // atomic OR of 0 — faults the page for write while preserving any value
    // a concurrent put may have stored there.
    for (uint64_t off = 0; off < len; off += 4096) {
      __atomic_fetch_or(reinterpret_cast<uint8_t*>(aligned + off), 0,
                        __ATOMIC_RELAXED);
    }
  }
}

void rtpu_store_destroy(const char* name) { shm_unlink(name); }

// ---------------------------------------------------------------- channels
//
// Seqno-gated mutable channels for compiled-DAG pipelines (capability
// analogue of the reference's mutable-object channels,
// src/ray/core_worker/experimental_mutable_object_manager.h). A channel is
// an ordinary sealed object whose payload starts with a ChanHeader: two
// monotonically increasing counters (seqno: writer publishes; ack: reader
// consumed) plus a PER-CHANNEL process-shared mutex+cond, so a post wakes
// only this channel's peer — never the whole store (a global cond turns a
// 3-stage pipeline into a context-switch storm on small hosts).

struct ChanHeader {
  uint64_t ctr[2];  // [0]=seqno, [1]=ack
  uint64_t len;     // payload length of the current message
  // parked-waiter count: a post only takes the mutex and broadcasts when
  // someone is actually parked on the cond. With a spinning (or absent)
  // peer a post is a pure release-store — no mutex, no futex wake — which
  // is what makes a hot pipelined hop syscall-free on BOTH sides. Field
  // sits after len so the Python side's len offset (16) is unchanged.
  uint64_t waiters;
  pthread_mutex_t mu;
  pthread_cond_t cv;
};

uint64_t rtpu_chan_header_size() { return sizeof(ChanHeader); }

static ChanHeader* chan_at(void* handle, uint64_t offset) {
  auto* s = static_cast<Store*>(handle);
  return reinterpret_cast<ChanHeader*>(s->base + offset);
}

int rtpu_chan_init(void* handle, uint64_t offset) {
  ChanHeader* c = chan_at(handle, offset);
  c->ctr[0] = c->ctr[1] = 0;
  c->len = 0;
  c->waiters = 0;
  pthread_mutexattr_t mattr;
  pthread_mutexattr_init(&mattr);
  pthread_mutexattr_setpshared(&mattr, PTHREAD_PROCESS_SHARED);
  pthread_mutexattr_setrobust(&mattr, PTHREAD_MUTEX_ROBUST);
  if (pthread_mutex_init(&c->mu, &mattr) != 0) return -1;
  pthread_condattr_t cattr;
  pthread_condattr_init(&cattr);
  pthread_condattr_setpshared(&cattr, PTHREAD_PROCESS_SHARED);
  // deadlines come from timespec_in (CLOCK_REALTIME); the cond must use
  // the same clock or timedwait deadlines never fire
  if (pthread_cond_init(&c->cv, &cattr) != 0) return -1;
  return 0;
}

static void chan_lock(ChanHeader* c) {
  if (pthread_mutex_lock(&c->mu) == EOWNERDEAD)
    pthread_mutex_consistent(&c->mu);
}

uint64_t rtpu_chan_seqno(void* handle, uint64_t offset, int which) {
  ChanHeader* c = chan_at(handle, offset);
  uint64_t v;
  __atomic_load(&c->ctr[which], &v, __ATOMIC_ACQUIRE);
  return v;
}

// Publish: store the counter (payload writes become visible before it),
// then wake this channel's peer — but only if one is actually PARKED.
// seq_cst on the counter store and the waiters load pairs with seq_cst
// on the waiter's registration store and counter re-check (Dekker
// pattern): at least one side observes the other, so either the post
// sees waiters>0 and broadcasts under the mutex, or the waiter's
// re-check (done before parking, under the mutex) sees the new value.
// The waiter's 50ms timedwait backstop self-heals any residual miss.
void rtpu_chan_post(void* handle, uint64_t offset, int which,
                    uint64_t value) {
  ChanHeader* c = chan_at(handle, offset);
  __atomic_store(&c->ctr[which], &value, __ATOMIC_SEQ_CST);
  uint64_t w;
  __atomic_load(&c->waiters, &w, __ATOMIC_SEQ_CST);
  if (w == 0) return;  // spinning or absent peer: no futex round-trip
  chan_lock(c);
  pthread_cond_broadcast(&c->cv);
  pthread_mutex_unlock(&c->mu);
}

// Wait until counter `which` exceeds `last`. Returns the observed value,
// or 0 on timeout (counters start at 1).
uint64_t rtpu_chan_wait(void* handle, uint64_t offset, int which,
                        uint64_t last, int timeout_ms) {
  ChanHeader* c = chan_at(handle, offset);
  uint64_t v = rtpu_chan_seqno(handle, offset, which);
  if (v > last) return v;
  struct timespec deadline;
  if (timeout_ms > 0) timespec_in(&deadline, timeout_ms);
  chan_lock(c);
  // register as PARKED before the re-check: a post that misses this
  // increment happened before it, so the re-check below sees its value
  // (seq_cst pairing with rtpu_chan_post)
  __atomic_add_fetch(&c->waiters, 1, __ATOMIC_SEQ_CST);
  for (;;) {
    uint64_t u;
    __atomic_load(&c->ctr[which], &u, __ATOMIC_SEQ_CST);
    v = u;
    if (v > last) {
      __atomic_sub_fetch(&c->waiters, 1, __ATOMIC_SEQ_CST);
      pthread_mutex_unlock(&c->mu);
      return v;
    }
    if (timeout_ms == 0) {
      __atomic_sub_fetch(&c->waiters, 1, __ATOMIC_SEQ_CST);
      pthread_mutex_unlock(&c->mu);
      return 0;
    }
    // Bounded waits even for timeout<0: a post can slip between the
    // atomic check and the cond wait; a 50ms re-check caps that stall
    // (the seq_cst waiters handshake makes it near-impossible, this is
    // a backstop).
    struct timespec tick;
    timespec_in(&tick, 50);
    int rc = pthread_cond_timedwait(&c->cv, &c->mu,
                                    timeout_ms < 0 ? &tick : &deadline);
    if (rc == ETIMEDOUT && timeout_ms > 0) {
      v = rtpu_chan_seqno(handle, offset, which);
      __atomic_sub_fetch(&c->waiters, 1, __ATOMIC_SEQ_CST);
      pthread_mutex_unlock(&c->mu);
      return v > last ? v : 0;
    }
  }
}

// Adaptive spin-then-block wait: busy-poll the counter atomic for up to
// `spin_us` microseconds before falling back to the condvar path above.
// A pipelined hop whose peer posts within the budget costs a cache-line
// read instead of a futex sleep + wakeup + ~18us context switch. Each
// poll round does a short burst of CPU pause hints then sched_yield()s:
// on a single-core host the peer NEEDS this core to post the counter, so
// an unyielding spin would stall the very event it waits for — yield
// keeps the round-trip at scheduler-quantum cost, still well under the
// futex path. spin_us == 0 degenerates to rtpu_chan_wait exactly.
uint64_t rtpu_chan_wait_spin(void* handle, uint64_t offset, int which,
                             uint64_t last, int timeout_ms,
                             uint32_t spin_us) {
  ChanHeader* c = chan_at(handle, offset);
  uint64_t v;
  __atomic_load(&c->ctr[which], &v, __ATOMIC_ACQUIRE);
  if (v > last) return v;
  if (spin_us > 0 && timeout_ms != 0) {
    struct timespec start, now;
    clock_gettime(CLOCK_MONOTONIC, &start);
    const int64_t budget_ns = static_cast<int64_t>(spin_us) * 1000;
    for (;;) {
      for (int i = 0; i < 64; ++i) {
#if defined(__x86_64__) || defined(__i386__)
        __builtin_ia32_pause();
#elif defined(__aarch64__)
        asm volatile("yield" ::: "memory");
#endif
        __atomic_load(&c->ctr[which], &v, __ATOMIC_ACQUIRE);
        if (v > last) return v;
      }
      clock_gettime(CLOCK_MONOTONIC, &now);
      int64_t elapsed_ns =
          (now.tv_sec - start.tv_sec) * 1000000000LL +
          (now.tv_nsec - start.tv_nsec);
      if (elapsed_ns >= budget_ns) break;
      sched_yield();  // single-core: hand the peer the CPU to post
    }
  }
  return rtpu_chan_wait(handle, offset, which, last, timeout_ms);
}

uint8_t* rtpu_store_base(void* handle) { return static_cast<Store*>(handle)->base; }
uint64_t rtpu_store_mapping_size(void* handle) { return static_cast<Store*>(handle)->size; }

// Allocate an object of `size` bytes; returns payload offset (0 on failure).
// The object is CREATED (not yet visible to getters) until sealed.
uint64_t rtpu_store_create_object(void* handle, const uint8_t* id, uint64_t size) {
  auto* s = static_cast<Store*>(handle);
  lock(s);
  Slot* slot = find_insert_slot(s, id);
  if (slot == nullptr) {
    unlock(s);
    return 0;  // table full or duplicate id
  }
  uint64_t off = heap_alloc(s, size);
  while (off == 0) {
    if (!evict_one(s)) break;
    off = heap_alloc(s, size);
  }
  if (off == 0) {
    unlock(s);
    return 0;
  }
  memcpy(slot->id, id, kIdLen);
  slot->state = SLOT_CREATED;
  slot->data_offset = off;
  slot->data_size = size;
  slot->refcount = 1;  // creator holds a reference until seal+release
  slot->lru_prev = slot->lru_next = 0;
  s->hdr->num_objects++;
  unlock(s);
  return off;
}

int rtpu_store_seal(void* handle, const uint8_t* id) {
  auto* s = static_cast<Store*>(handle);
  lock(s);
  Slot* slot = find_slot(s, id, false);
  if (!slot || slot->state != SLOT_CREATED) {
    unlock(s);
    return -1;
  }
  slot->state = SLOT_SEALED;
  slot->refcount -= 1;  // drop creator ref
  if (slot->refcount == 0) lru_push_back(s, slot);
  pthread_cond_broadcast(&s->hdr->seal_cond);
  unlock(s);
  return 0;
}

// Seal keeping the creator reference (refcount stays >= 1). Used for the
// owner-handoff protocol: a task-return/put container is born referenced,
// and the owner process adopts that reference as its tracking pin — there
// is never a refcount==0 window in which the LRU could evict a live object.
int rtpu_store_seal_retain(void* handle, const uint8_t* id) {
  auto* s = static_cast<Store*>(handle);
  lock(s);
  Slot* slot = find_slot(s, id, false);
  if (!slot || slot->state != SLOT_CREATED) {
    unlock(s);
    return -1;
  }
  slot->state = SLOT_SEALED;
  pthread_cond_broadcast(&s->hdr->seal_cond);
  unlock(s);
  return 0;
}

// Get: waits up to timeout_ms for the object to exist+seal. On success fills
// offset/size, bumps refcount (pinning it against eviction), returns 0.
// Returns -1 on timeout.
int rtpu_store_get(void* handle, const uint8_t* id, int timeout_ms,
                   uint64_t* offset, uint64_t* size) {
  auto* s = static_cast<Store*>(handle);
  struct timespec deadline;
  if (timeout_ms > 0) timespec_in(&deadline, timeout_ms);
  lock(s);
  for (;;) {
    Slot* slot = find_slot(s, id, false);
    if (slot && slot->state == SLOT_SEALED) {
      if (slot->refcount == 0) lru_unlink(s, slot);
      slot->refcount += 1;
      *offset = slot->data_offset;
      *size = slot->data_size;
      unlock(s);
      return 0;
    }
    if (timeout_ms == 0) {
      unlock(s);
      return -1;
    }
    int rc;
    if (timeout_ms < 0) {
      rc = pthread_cond_wait(&s->hdr->seal_cond, &s->hdr->mutex);
    } else {
      rc = pthread_cond_timedwait(&s->hdr->seal_cond, &s->hdr->mutex, &deadline);
    }
    if (rc == ETIMEDOUT) {
      unlock(s);
      return -1;
    }
  }
}

int rtpu_store_release(void* handle, const uint8_t* id) {
  auto* s = static_cast<Store*>(handle);
  lock(s);
  Slot* slot = find_slot(s, id, false);
  if (!slot || slot->refcount <= 0) {
    unlock(s);
    return -1;
  }
  slot->refcount -= 1;
  if (slot->refcount == 0 && slot->state == SLOT_SEALED) lru_push_back(s, slot);
  unlock(s);
  return 0;
}

// Current refcount of an object (-1 if absent). Lets the owner identify
// objects only it references (safe to spill/delete: refcount == its pins).
int64_t rtpu_store_refcount(void* handle, const uint8_t* id) {
  auto* s = static_cast<Store*>(handle);
  lock(s);
  Slot* slot = find_slot(s, id, false);
  int64_t r = slot ? slot->refcount : -1;
  unlock(s);
  return r;
}

int rtpu_store_contains(void* handle, const uint8_t* id) {
  auto* s = static_cast<Store*>(handle);
  lock(s);
  Slot* slot = find_slot(s, id, false);
  int r = (slot && slot->state == SLOT_SEALED) ? 1 : 0;
  unlock(s);
  return r;
}

// Explicit delete (out-of-band ref-count driven, from the owner). Frees now if
// unreferenced, else marks for eviction at refcount 0 (here: just LRU'd).
int rtpu_store_delete(void* handle, const uint8_t* id) {
  auto* s = static_cast<Store*>(handle);
  lock(s);
  Slot* slot = find_slot(s, id, false);
  if (!slot) {
    unlock(s);
    return -1;
  }
  if (slot->refcount == 0) {
    if (slot->state == SLOT_SEALED) lru_unlink(s, slot);
    heap_free(s, slot->data_offset, align_up(slot->data_size));
    s->hdr->bytes_in_use -= align_up(slot->data_size);
    s->hdr->num_objects--;
    slot->state = SLOT_TOMBSTONE;
  }
  // else: pinned; it will fall into LRU when released and evict under pressure.
  unlock(s);
  return 0;
}

void rtpu_store_stats(void* handle, uint64_t* heap_size, uint64_t* bytes_in_use,
                      uint64_t* num_objects, uint64_t* evictions) {
  auto* s = static_cast<Store*>(handle);
  lock(s);
  *heap_size = s->hdr->heap_size;
  *bytes_in_use = s->hdr->bytes_in_use;
  *num_objects = s->hdr->num_objects;
  *evictions = s->hdr->evictions;
  unlock(s);
}

}  // extern "C"
