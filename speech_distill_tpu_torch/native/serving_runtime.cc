// Native serving runtime: page-pool allocator + exact-token prefix trie.
//
// The host side of the paged-KV engine (infer/paged.py) — the vLLM "block
// manager" role. The Python twins (PagePool, PrefixRegistry) remain as
// fallbacks; tests assert behavioral identity. The port keeps its own copy
// of the JAX package's runtime (speech_distill_tpu/native/serving_runtime.cc).
//
// Why native: the Python registry keys every page-aligned prefix by its FULL
// token tuple — match/register hash O(n) tokens per page, O(n^2/ps) per
// request (a 4k-token multi-turn context hashes ~65k tokens per admission).
// The trie compares one ps-token chunk per level (O(n) per request), in C++.
// Exactness is preserved: nodes store the actual chunk tokens, so a hash
// collision can never alias two different prefixes onto one KV page.
//
// C ABI, handle-based; bound via ctypes (native/serving.py).

#include <cstdint>
#include <cstring>
#include <map>
#include <memory>
#include <unordered_map>
#include <vector>

namespace {

struct Pool {
  std::vector<int32_t> free_list;          // top = back
  std::unordered_map<int32_t, int32_t> ref;

  explicit Pool(int32_t num_pages) {
    free_list.reserve(num_pages);
    for (int32_t p = num_pages - 1; p >= 0; --p) free_list.push_back(p);
  }
};

// Trie over page-granularity token chunks. A node exists per REGISTERED
// page-aligned prefix; children are keyed by the next ps-token chunk.
// Eviction tombstones the node (page freed, children kept — they stay
// unreachable for match exactly like the Python flat map, whose walk stops
// at the first missing key, and keep their own pool references until their
// own eviction).
struct Node {
  // key: exact chunk tokens -> child (std::map over vectors: ordered,
  // exact comparison — correctness over micro-speed; chunk compare is the
  // O(ps) per level that replaces Python's O(prefix) hash per level)
  std::map<std::vector<int32_t>, std::unique_ptr<Node>> children;
  int32_t page = -1;     // pool page holding this prefix's KV
  int64_t last = 0;      // LRU clock
  bool live = false;     // false = tombstoned (evicted) or never registered
};

struct Registry {
  Node root;
  int64_t clock = 0;
  int64_t live_count = 0;
};

std::unordered_map<int64_t, std::unique_ptr<Pool>> g_pools;
std::unordered_map<int64_t, std::unique_ptr<Registry>> g_regs;
int64_t g_next = 1;

Pool* pool_of(int64_t h) {
  auto it = g_pools.find(h);
  return it == g_pools.end() ? nullptr : it->second.get();
}
Registry* reg_of(int64_t h) {
  auto it = g_regs.find(h);
  return it == g_regs.end() ? nullptr : it->second.get();
}

void collect_lru(Node* n, Pool* pool, Node** best) {
  if (n->live) {
    auto it = pool->ref.find(n->page);
    if (it != pool->ref.end() && it->second == 1) {
      if (*best == nullptr || n->last < (*best)->last) *best = n;
    }
  }
  for (auto& kv : n->children) collect_lru(kv.second.get(), pool, best);
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------- pool ---
int64_t sdt_pool_new(int32_t num_pages) {
  int64_t h = g_next++;
  g_pools[h] = std::make_unique<Pool>(num_pages);
  return h;
}

void sdt_pool_delete(int64_t h) { g_pools.erase(h); }

int32_t sdt_pool_free_pages(int64_t h) {
  Pool* p = pool_of(h);
  return p ? static_cast<int32_t>(p->free_list.size()) : -1;
}

// alloc n pages into out[0..n); returns 1 on success, 0 if insufficient
// (state unchanged). Pop order matches the Python list.pop() twin.
int32_t sdt_pool_alloc(int64_t h, int32_t n, int32_t* out) {
  Pool* p = pool_of(h);
  if (!p || n > static_cast<int32_t>(p->free_list.size())) return 0;
  for (int32_t i = 0; i < n; ++i) {
    int32_t page = p->free_list.back();
    p->free_list.pop_back();
    p->ref[page] = 1;
    out[i] = page;
  }
  return 1;
}

void sdt_pool_share(int64_t h, const int32_t* pages, int32_t n) {
  Pool* p = pool_of(h);
  if (!p) return;
  for (int32_t i = 0; i < n; ++i) p->ref[pages[i]] += 1;
}

void sdt_pool_release(int64_t h, const int32_t* pages, int32_t n) {
  Pool* p = pool_of(h);
  if (!p) return;
  for (int32_t i = 0; i < n; ++i) {
    auto it = p->ref.find(pages[i]);
    if (it == p->ref.end()) continue;
    if (--it->second == 0) {
      p->ref.erase(it);
      p->free_list.push_back(pages[i]);
    }
  }
}

int32_t sdt_pool_refcount(int64_t h, int32_t page) {
  Pool* p = pool_of(h);
  if (!p) return 0;
  auto it = p->ref.find(page);
  return it == p->ref.end() ? 0 : it->second;
}

// ------------------------------------------------------------ registry ---
int64_t sdt_reg_new(void) {
  int64_t h = g_next++;
  g_regs[h] = std::make_unique<Registry>();
  return h;
}

void sdt_reg_delete(int64_t h) { g_regs.erase(h); }

int64_t sdt_reg_size(int64_t h) {
  Registry* r = reg_of(h);
  return r ? r->live_count : -1;
}

// Longest registered page-aligned prefix of ids[0..n_ids): walks full
// ps-token chunks while a LIVE node exists, refreshes each hit's LRU
// stamp, writes hit pages root-first into out (capacity max_pages).
// Returns the number of hit pages.
int32_t sdt_reg_match(int64_t h, const int32_t* ids, int64_t n_ids,
                      int32_t ps, int32_t max_pages, int32_t* out) {
  Registry* r = reg_of(h);
  if (!r) return 0;
  Node* cur = &r->root;
  int32_t hits = 0;
  std::vector<int32_t> chunk(ps);
  int64_t limit = n_ids / ps;
  if (limit > max_pages) limit = max_pages;
  for (int64_t i = 0; i < limit; ++i) {
    std::memcpy(chunk.data(), ids + i * ps, ps * sizeof(int32_t));
    auto it = cur->children.find(chunk);
    if (it == cur->children.end() || !it->second->live) break;
    cur = it->second.get();
    cur->last = ++r->clock;
    out[hits++] = cur->page;
  }
  return hits;
}

// Register every full page of ids[0..n_ids) against stream_pages (one page
// id per chunk). New nodes (or tombstone revivals) take one pool reference
// on their page; existing live nodes are left untouched (Python parity:
// "if key not in self._map"). Returns number of newly registered pages.
int32_t sdt_reg_register(int64_t h, int64_t pool_h, const int32_t* ids,
                         int64_t n_ids, const int32_t* stream_pages,
                         int32_t ps) {
  Registry* r = reg_of(h);
  Pool* pool = pool_of(pool_h);
  if (!r || !pool) return 0;
  Node* cur = &r->root;
  int32_t fresh = 0;
  std::vector<int32_t> chunk(ps);
  for (int64_t i = 0; i < n_ids / ps; ++i) {
    std::memcpy(chunk.data(), ids + i * ps, ps * sizeof(int32_t));
    auto it = cur->children.find(chunk);
    if (it == cur->children.end()) {
      auto node = std::make_unique<Node>();
      it = cur->children.emplace(chunk, std::move(node)).first;
    }
    Node* child = it->second.get();
    if (!child->live) {
      child->live = true;
      child->page = stream_pages[i];
      child->last = ++r->clock;
      pool->ref[stream_pages[i]] += 1;
      ++r->live_count;
      ++fresh;
    }
    cur = child;
  }
  return fresh;
}

// Free the LRU live node whose page no live stream holds (refcount == 1,
// i.e. only the registry's own reference). Returns 1 if evicted.
int32_t sdt_reg_evict_one(int64_t h, int64_t pool_h) {
  Registry* r = reg_of(h);
  Pool* pool = pool_of(pool_h);
  if (!r || !pool) return 0;
  Node* best = nullptr;
  collect_lru(&r->root, pool, &best);
  if (!best) return 0;
  int32_t page = best->page;
  best->live = false;
  best->page = -1;
  --r->live_count;
  const int32_t one[1] = {page};
  sdt_pool_release(pool_h, one, 1);
  return 1;
}

}  // extern "C"
