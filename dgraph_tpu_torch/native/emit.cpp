// JSON emitter over columnar level trees.
//
// Reference parity: query/outputnode.go (fastJsonNode → ToJson). The
// reference's answer to render cost is a purpose-built byte-tree encoder
// in Go; ours is this: the Python side lowers an executed LevelNode tree
// to flat arrays (per-leaf pre-encoded JSON fragments aligned to the
// level's rank domain, per-child CSR row maps in domain-position space)
// and this walker emits the response bytes directly — no per-object
// Python allocation on the serving path.
//
// Semantics mirrored from engine/outputnode.py's dict path exactly:
//   - leaves in declaration order, then child edges in order
//   - absent values (empty fragment span) omit the key
//   - empty child lists omit the key; empty objects are dropped from lists
//   - repeated subtrees memoized per (level, domain position)
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <utility>
#include <vector>

struct DgLevel;

struct DgLeaf {
  const uint8_t* key;  // pre-encoded `"name":`
  int64_t key_len;
  int32_t kind;  // 0 = fragment, 1 = uid hex string, 2 = int64
  int32_t pad_;
  const int64_t* frag_off;  // [n+1] blob spans, kind 0 (equal span = absent)
  const uint8_t* frag_blob;
  const int64_t* nums;  // [n], kind 1/2
};

struct DgChild {
  const uint8_t* key;
  int64_t key_len;
  const DgLevel* level;
  const int64_t* row_indptr;  // [parent n + 1]
  const int32_t* row_child;   // positions into child level's domain
};

struct DgLevel {
  int64_t n;  // domain size
  int64_t n_leaves;
  const DgLeaf* leaves;
  int64_t n_children;
  const DgChild* children;
  int64_t level_id;  // dense index for the memo workspace
};

namespace {

struct Emitter {
  std::string out;
  // per level: domain position -> (start, len) of its emitted bytes
  std::vector<std::vector<std::pair<int64_t, int64_t>>> memo;

  void append_span(int64_t start, int64_t len) {
    size_t old = out.size();
    out.resize(old + len);
    memmove(&out[old], &out[start], len);
  }

  void emit_obj(const DgLevel* lv, int64_t p) {
    auto& m = memo[lv->level_id];
    if ((int64_t)m.size() < lv->n) m.assign(lv->n, {0, 0});
    if (m[p].second) {
      append_span(m[p].first, m[p].second);
      return;
    }
    int64_t start = out.size();
    out.push_back('{');
    bool first = true;
    for (int64_t i = 0; i < lv->n_leaves; ++i) {
      const DgLeaf& lf = lv->leaves[i];
      if (lf.kind == 0) {
        int64_t a = lf.frag_off[p], b = lf.frag_off[p + 1];
        if (b <= a) continue;
        if (!first) out.push_back(',');
        first = false;
        out.append((const char*)lf.key, lf.key_len);
        out.append((const char*)lf.frag_blob + a, b - a);
      } else {
        char buf[32];
        int n;
        if (lf.kind == 1) {
          n = snprintf(buf, sizeof buf, "\"0x%llx\"",
                       (unsigned long long)lf.nums[p]);
        } else {
          n = snprintf(buf, sizeof buf, "%lld", (long long)lf.nums[p]);
        }
        if (!first) out.push_back(',');
        first = false;
        out.append((const char*)lf.key, lf.key_len);
        out.append(buf, n);
      }
    }
    for (int64_t i = 0; i < lv->n_children; ++i) {
      const DgChild& ch = lv->children[i];
      int64_t s = ch.row_indptr[p], e = ch.row_indptr[p + 1];
      if (e <= s) continue;
      int64_t mark = out.size();
      if (!first) out.push_back(',');
      out.append((const char*)ch.key, ch.key_len);
      out.push_back('[');
      bool any = false;
      for (int64_t j = s; j < e; ++j) {
        int64_t cm = out.size();
        if (any) out.push_back(',');
        size_t pre = out.size();
        emit_obj(ch.level, ch.row_child[j]);
        if (out.size() - pre == 2) {
          out.resize(cm);  // "{}": drop the object (and its comma)
        } else {
          any = true;
        }
      }
      if (!any) {
        out.resize(mark);  // every row object was empty: drop the key
      } else {
        out.push_back(']');
        first = false;
      }
    }
    out.push_back('}');
    int64_t len = (int64_t)out.size() - start;
    // never memoize "{}": empty objects get truncated by the caller, so
    // a remembered span would dangle past out.size() once rolled back
    if (len > 2) m[p] = {start, len};
  }
};

}  // namespace

extern "C" int64_t dg_emit_block(const DgLevel* root, const int32_t* display,
                                 int64_t n_display, int64_t n_levels,
                                 uint8_t** out_buf) {
  Emitter e;
  e.memo.resize(n_levels);
  e.out.reserve(1 << 16);
  e.out.push_back('[');
  bool any = false;
  for (int64_t i = 0; i < n_display; ++i) {
    int64_t cm = e.out.size();
    if (any) e.out.push_back(',');
    size_t pre = e.out.size();
    e.emit_obj(root, display[i]);
    if (e.out.size() - pre == 2) {
      e.out.resize(cm);
    } else {
      any = true;
    }
  }
  e.out.push_back(']');
  uint8_t* buf = (uint8_t*)malloc(e.out.size());
  if (!buf) return -1;
  memcpy(buf, e.out.data(), e.out.size());
  *out_buf = buf;
  return (int64_t)e.out.size();
}

extern "C" void dg_emit_free(uint8_t* p) { free(p); }
