// Native event-log codec/scanner for the `binevents` storage backend.
//
// This is the native runtime data-loader: the training
// workflow's hot path is a full event scan (reference: Engine.scala:644
// readTrainingBase -> PEvents.find -> HBase TableInputFormat full table
// scan, SURVEY.md §3.1 "[HOT: full event scan]"). Where the reference
// delegates that scan to the JVM/HBase region servers, this library does
// the file IO, record framing, CRC verification, tombstone compaction and
// fixed-field filtering in C++; Python only JSON-parses the surviving
// payloads.
//
// File format (little-endian):
//   header: 8 bytes magic "PIOEVT1\n"
//   record: u32 body_len, u32 crc32(body), body
//     body: u8 op (0=put, 1=del)
//       del: u16 id_len, id bytes
//       put: i64 event_time (microseconds since epoch, UTC)
//            u16 id_len,  id
//            u16 name_len, event name
//            u16 etype_len, entity type
//            u16 eid_len,  entity id
//            u16 tet_len,  target entity type  (0xFFFF = absent)
//            u16 tei_len,  target entity id    (0xFFFF = absent)
//            u32 json_len, full canonical event JSON
//   A torn/corrupt tail record terminates the scan (normal append-crash
//   semantics); everything before it is served.
//
// C ABI (ctypes-consumed; see predictionio_tpu_torch/native/__init__.py):
//   pio_open/pio_close/pio_write_put/pio_write_del/pio_flush
//   pio_scan (filtered, compacted scan -> [u32 n][u32 len,json]*)
//   pio_get  (single id lookup)
//   pio_free

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

#include <unistd.h>

namespace {

constexpr char kMagic[8] = {'P', 'I', 'O', 'E', 'V', 'T', '1', '\n'};
constexpr uint16_t kAbsent = 0xFFFF;

uint32_t crc_table[256];
bool crc_init_done = false;

void crc_init() {
  if (crc_init_done) return;
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = i;
    for (int k = 0; k < 8; k++) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
    crc_table[i] = c;
  }
  crc_init_done = true;
}

uint32_t crc32(const uint8_t* buf, size_t len) {
  crc_init();
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < len; i++) c = crc_table[(c ^ buf[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

void put_u16(std::string& out, uint16_t v) { out.append((const char*)&v, 2); }
void put_u32(std::string& out, uint32_t v) { out.append((const char*)&v, 4); }
void put_i64(std::string& out, int64_t v) { out.append((const char*)&v, 8); }

void put_str16(std::string& out, const char* s) {
  if (s == nullptr) {
    put_u16(out, kAbsent);
    return;
  }
  size_t n = strlen(s);
  if (n >= kAbsent) n = kAbsent - 1;  // fixed fields are ids/names, never this long
  put_u16(out, (uint16_t)n);
  out.append(s, n);
}

struct Writer {
  FILE* f;
};

// One live (post-compaction) event's filterable view + payload.
struct LiveEvent {
  int64_t t_us;
  std::string name, etype, eid;
  bool has_tet, has_tei;
  std::string tet, tei;
  std::string json;
};

struct Cursor {
  const uint8_t* p;
  size_t n;
  bool ok = true;

  bool need(size_t k) {
    if (n < k) { ok = false; return false; }
    return true;
  }
  uint16_t u16() {
    if (!need(2)) return 0;
    uint16_t v; memcpy(&v, p, 2); p += 2; n -= 2; return v;
  }
  uint32_t u32() {
    if (!need(4)) return 0;
    uint32_t v; memcpy(&v, p, 4); p += 4; n -= 4; return v;
  }
  int64_t i64() {
    if (!need(8)) return 0;
    int64_t v; memcpy(&v, p, 8); p += 8; n -= 8; return v;
  }
  std::string bytes(size_t k) {
    if (!need(k)) return std::string();
    std::string s((const char*)p, k); p += k; n -= k; return s;
  }
};

// Replay the log into id -> LiveEvent (last put wins, del removes).
// Returns false only on open failure; a corrupt/torn tail just stops
// the replay.
bool replay(const char* path,
            std::unordered_map<std::string, LiveEvent>& live) {
  FILE* f = fopen(path, "rb");
  if (f == nullptr) return false;
  char magic[8];
  if (fread(magic, 1, 8, f) != 8 || memcmp(magic, kMagic, 8) != 0) {
    fclose(f);
    return true;  // empty/new file: nothing to replay
  }
  std::vector<uint8_t> body;
  for (;;) {
    uint32_t hdr[2];
    if (fread(hdr, 1, 8, f) != 8) break;
    uint32_t body_len = hdr[0], crc = hdr[1];
    if (body_len > (1u << 30)) break;  // implausible: corrupt length
    body.resize(body_len);
    if (fread(body.data(), 1, body_len, f) != body_len) break;  // torn tail
    if (crc32(body.data(), body_len) != crc) break;             // corrupt
    Cursor c{body.data(), body_len};
    uint8_t op = 0;
    if (!c.need(1)) continue;
    op = *c.p; c.p++; c.n--;
    if (op == 1) {  // del
      uint16_t idl = c.u16();
      std::string id = c.bytes(idl);
      if (c.ok) live.erase(id);
      continue;
    }
    LiveEvent ev;
    ev.t_us = c.i64();
    std::string id = c.bytes(c.u16());
    ev.name = c.bytes(c.u16());
    ev.etype = c.bytes(c.u16());
    ev.eid = c.bytes(c.u16());
    uint16_t tetl = c.u16();
    ev.has_tet = (tetl != kAbsent);
    if (ev.has_tet) ev.tet = c.bytes(tetl);
    uint16_t teil = c.u16();
    ev.has_tei = (teil != kAbsent);
    if (ev.has_tei) ev.tei = c.bytes(teil);
    ev.json = c.bytes(c.u32());
    if (c.ok) live[id] = std::move(ev);
  }
  fclose(f);
  return true;
}

// Byte length of the valid record prefix (header + intact records), or
// -1 if the file is non-empty with a foreign/corrupt header.
int64_t valid_prefix(FILE* f) {
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  if (size == 0) return 0;
  fseek(f, 0, SEEK_SET);
  char magic[8];
  if (size < 8 || fread(magic, 1, 8, f) != 8 || memcmp(magic, kMagic, 8) != 0)
    return -1;
  int64_t good = 8;
  std::vector<uint8_t> body;
  for (;;) {
    uint32_t hdr[2];
    if (fread(hdr, 1, 8, f) != 8) break;
    uint32_t body_len = hdr[0], crc = hdr[1];
    if (body_len > (1u << 30)) break;
    body.resize(body_len);
    if (fread(body.data(), 1, body_len, f) != body_len) break;
    if (crc32(body.data(), body_len) != crc) break;
    good += 8 + (int64_t)body_len;
  }
  return good;
}

}  // namespace

extern "C" {

// Opens for append, first truncating any torn/corrupt tail so records
// written after a crash are not appended behind an unreadable record
// (replay stops at the first bad record — without the repair those
// writes would be acknowledged but permanently invisible).
void* pio_open(const char* path) {
  FILE* f = fopen(path, "r+b");
  if (f == nullptr) {
    f = fopen(path, "wb");
    if (f == nullptr) return nullptr;
    if (fwrite(kMagic, 1, 8, f) != 8) { fclose(f); return nullptr; }
    fflush(f);
    return new Writer{f};
  }
  int64_t good = valid_prefix(f);
  if (good < 0) { fclose(f); return nullptr; }  // not an event log
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  if (good == 0) {  // empty file: write the header
    fseek(f, 0, SEEK_SET);
    if (fwrite(kMagic, 1, 8, f) != 8) { fclose(f); return nullptr; }
    fflush(f);
    good = 8;
  }
  if (size > good) {
    fflush(f);
    if (ftruncate(fileno(f), good) != 0) { fclose(f); return nullptr; }
  }
  fseek(f, (long)good, SEEK_SET);
  return new Writer{f};
}

int pio_close(void* h) {
  if (h == nullptr) return -1;
  Writer* w = (Writer*)h;
  int rc = fclose(w->f);
  delete w;
  return rc == 0 ? 0 : -1;
}

int pio_flush(void* h) {
  if (h == nullptr) return -1;
  return fflush(((Writer*)h)->f) == 0 ? 0 : -1;
}

static int write_record(Writer* w, const std::string& body) {
  uint32_t len = (uint32_t)body.size();
  uint32_t crc = crc32((const uint8_t*)body.data(), body.size());
  if (fwrite(&len, 1, 4, w->f) != 4) return -1;
  if (fwrite(&crc, 1, 4, w->f) != 4) return -1;
  if (fwrite(body.data(), 1, body.size(), w->f) != body.size()) return -1;
  return fflush(w->f) == 0 ? 0 : -1;
}

int pio_write_put(void* h, int64_t t_us, const char* id, const char* name,
                  const char* etype, const char* eid, const char* tet,
                  const char* tei, const uint8_t* json, uint32_t json_len) {
  if (h == nullptr || id == nullptr || name == nullptr) return -1;
  std::string body;
  body.reserve(64 + json_len);
  body.push_back((char)0);
  put_i64(body, t_us);
  put_str16(body, id);
  put_str16(body, name);
  put_str16(body, etype ? etype : "");
  put_str16(body, eid ? eid : "");
  put_str16(body, tet);  // NULL -> absent sentinel
  put_str16(body, tei);
  put_u32(body, json_len);
  body.append((const char*)json, json_len);
  return write_record((Writer*)h, body);
}

int pio_write_del(void* h, const char* id) {
  if (h == nullptr || id == nullptr) return -1;
  std::string body;
  body.push_back((char)1);
  put_str16(body, id);
  return write_record((Writer*)h, body);
}

// Filtered, compacted scan. Mode for target fields: 0 = any,
// 1 = must be absent, 2 = must equal the given value (matching
// EventFilter.matches, storage/base.py). Output: [u32 n][u32 len,json]*
// in unspecified order (the Python side sorts by event time).
int pio_scan(const char* path, int has_start, int64_t start_us, int has_until,
             int64_t until_us, const char* entity_type, const char* entity_id,
             const char* const* names, int32_t n_names, int tet_mode,
             const char* tet, int tei_mode, const char* tei, uint8_t** out,
             uint64_t* out_len) {
  if (out == nullptr || out_len == nullptr) return -1;
  std::unordered_map<std::string, LiveEvent> live;
  if (!replay(path, live)) return -2;

  std::string buf;
  uint32_t count = 0;
  put_u32(buf, 0);  // placeholder
  for (const auto& kv : live) {
    const LiveEvent& e = kv.second;
    if (has_start && e.t_us < start_us) continue;
    if (has_until && e.t_us >= until_us) continue;
    if (entity_type != nullptr && e.etype != entity_type) continue;
    if (entity_id != nullptr && e.eid != entity_id) continue;
    if (names != nullptr && n_names > 0) {
      bool hit = false;
      for (int32_t i = 0; i < n_names && !hit; i++)
        hit = (names[i] != nullptr && e.name == names[i]);
      if (!hit) continue;
    }
    if (tet_mode == 1 && e.has_tet) continue;
    if (tet_mode == 2 && (!e.has_tet || e.tet != (tet ? tet : ""))) continue;
    if (tei_mode == 1 && e.has_tei) continue;
    if (tei_mode == 2 && (!e.has_tei || e.tei != (tei ? tei : ""))) continue;
    put_u32(buf, (uint32_t)e.json.size());
    buf.append(e.json);
    count++;
  }
  memcpy(&buf[0], &count, 4);
  uint8_t* mem = (uint8_t*)malloc(buf.size());
  if (mem == nullptr) return -3;
  memcpy(mem, buf.data(), buf.size());
  *out = mem;
  *out_len = buf.size();
  return 0;
}

// Single-id lookup: returns 0 and the JSON payload if live, 1 if absent.
int pio_get(const char* path, const char* id, uint8_t** out,
            uint64_t* out_len) {
  if (id == nullptr || out == nullptr || out_len == nullptr) return -1;
  std::unordered_map<std::string, LiveEvent> live;
  if (!replay(path, live)) return -2;
  auto it = live.find(id);
  if (it == live.end()) return 1;
  const std::string& json = it->second.json;
  uint8_t* mem = (uint8_t*)malloc(json.size() ? json.size() : 1);
  if (mem == nullptr) return -3;
  memcpy(mem, json.data(), json.size());
  *out = mem;
  *out_len = json.size();
  return 0;
}

void pio_free(uint8_t* p) { free(p); }

}  // extern "C"
