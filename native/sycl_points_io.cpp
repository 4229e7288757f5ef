// Native host-side I/O runtime for sycl_points_tpu.
//
// The reference implements its entire I/O layer in C++
// (io/point_cloud_reader.hpp, io/point_cloud_writer.hpp in
// fateshelled/sycl_points).  The compute path is XLA, but the host
// runtime around it stays native: this library provides
//   * a fast PLY reader (ASCII + binary_little_endian),
//   * a KITTI Velodyne .bin reader,
//   * a background prefetching sequence loader (double-buffered reader
//     thread) so scan N+1 is parsed from disk while scan N is on device.
//
// C ABI, bound from Python via ctypes (points/native_io.py), with a pure
// numpy fallback when the library is not built.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <fstream>
#include <mutex>
#include <sstream>
#include <string>
#include <thread>
#include <vector>

extern "C" {

struct SptCloud {
  float* points = nullptr;       // n x 3
  float* intensity = nullptr;    // n (nullable)
  float* normals = nullptr;      // n x 3 (nullable)
  float* rgb = nullptr;          // n x 4 in [0,1] (nullable)
  float* timestamps = nullptr;   // n (nullable)
  int64_t n = 0;
  int32_t ok = 0;
  char error[256] = {0};
};

void spt_free_cloud(SptCloud* c) {
  if (!c) return;
  std::free(c->points);
  std::free(c->intensity);
  std::free(c->normals);
  std::free(c->rgb);
  std::free(c->timestamps);
  delete c;
}

}  // extern "C"

namespace {

struct PlyProperty {
  std::string name;
  int size = 4;
  char kind = 'f';  // f=float, i=int, u=uint
};

int type_size(const std::string& t, char* kind) {
  if (t == "char" || t == "int8") { *kind = 'i'; return 1; }
  if (t == "uchar" || t == "uint8") { *kind = 'u'; return 1; }
  if (t == "short" || t == "int16") { *kind = 'i'; return 2; }
  if (t == "ushort" || t == "uint16") { *kind = 'u'; return 2; }
  if (t == "int" || t == "int32") { *kind = 'i'; return 4; }
  if (t == "uint" || t == "uint32") { *kind = 'u'; return 4; }
  if (t == "float" || t == "float32") { *kind = 'f'; return 4; }
  if (t == "double" || t == "float64") { *kind = 'f'; return 8; }
  return 0;
}

double read_scalar(const uint8_t* p, const PlyProperty& prop) {
  switch (prop.kind) {
    case 'f':
      if (prop.size == 4) { float v; std::memcpy(&v, p, 4); return v; }
      else { double v; std::memcpy(&v, p, 8); return v; }
    case 'i':
      if (prop.size == 1) return *reinterpret_cast<const int8_t*>(p);
      if (prop.size == 2) { int16_t v; std::memcpy(&v, p, 2); return v; }
      { int32_t v; std::memcpy(&v, p, 4); return v; }
    default:
      if (prop.size == 1) return *p;
      if (prop.size == 2) { uint16_t v; std::memcpy(&v, p, 2); return v; }
      { uint32_t v; std::memcpy(&v, p, 4); return v; }
  }
}

SptCloud* fail(SptCloud* c, const char* msg) {
  std::snprintf(c->error, sizeof(c->error), "%s", msg);
  c->ok = 0;
  return c;
}

bool iequals_contains(const std::string& s, const char* needle) {
  std::string lower = s;
  for (auto& ch : lower) ch = static_cast<char>(std::tolower(ch));
  return lower.find(needle) != std::string::npos;
}

}  // namespace

extern "C" {

SptCloud* spt_read_ply(const char* path) {
  auto* out = new SptCloud();
  std::ifstream f(path, std::ios::binary);
  if (!f) return fail(out, "cannot open file");

  std::string line, format;
  int64_t n_vertex = 0;
  std::vector<PlyProperty> props;
  bool in_vertex = false;
  if (!std::getline(f, line) || line.rfind("ply", 0) != 0)
    return fail(out, "not a PLY file");
  while (std::getline(f, line)) {
    if (!line.empty() && line.back() == '\r') line.pop_back();
    std::istringstream ss(line);
    std::string tok;
    ss >> tok;
    if (tok == "format") {
      ss >> format;
    } else if (tok == "element") {
      std::string what;
      ss >> what >> n_vertex;
      in_vertex = (what == "vertex");
      if (!in_vertex) n_vertex = n_vertex;  // other elements unsupported below
    } else if (tok == "property" && in_vertex) {
      std::string type, name;
      ss >> type;
      if (type == "list") return fail(out, "list properties unsupported");
      ss >> name;
      PlyProperty p;
      p.name = name;
      p.size = type_size(type, &p.kind);
      if (p.size == 0) return fail(out, "unknown property type");
      props.push_back(p);
    } else if (tok == "end_header") {
      break;
    }
  }
  if (n_vertex <= 0 || props.empty()) return fail(out, "no vertex element");

  int ix = -1, iy = -1, iz = -1, ii = -1, inx = -1, iny = -1, inz = -1;
  int ir = -1, ig = -1, ib = -1, ia = -1, it = -1;
  for (size_t k = 0; k < props.size(); ++k) {
    const auto& nm = props[k].name;
    if (nm == "x") ix = (int)k;
    else if (nm == "y") iy = (int)k;
    else if (nm == "z") iz = (int)k;
    else if (nm == "nx") inx = (int)k;
    else if (nm == "ny") iny = (int)k;
    else if (nm == "nz") inz = (int)k;
    else if (nm == "red") ir = (int)k;
    else if (nm == "green") ig = (int)k;
    else if (nm == "blue") ib = (int)k;
    else if (nm == "alpha") ia = (int)k;
    else if (ii < 0 && iequals_contains(nm, "intensity")) ii = (int)k;
    else if (it < 0 && (nm == "time" || nm == "t" || iequals_contains(nm, "time"))) it = (int)k;
  }
  if (ix < 0 || iy < 0 || iz < 0) return fail(out, "missing x/y/z");

  const int64_t n = n_vertex;
  out->points = static_cast<float*>(std::malloc(sizeof(float) * 3 * n));
  if (ii >= 0) out->intensity = static_cast<float*>(std::malloc(sizeof(float) * n));
  if (inx >= 0 && iny >= 0 && inz >= 0)
    out->normals = static_cast<float*>(std::malloc(sizeof(float) * 3 * n));
  if (ir >= 0 && ig >= 0 && ib >= 0)
    out->rgb = static_cast<float*>(std::malloc(sizeof(float) * 4 * n));
  if (it >= 0) out->timestamps = static_cast<float*>(std::malloc(sizeof(float) * n));

  auto emit = [&](int64_t row, const std::vector<double>& vals) {
    out->points[row * 3 + 0] = static_cast<float>(vals[ix]);
    out->points[row * 3 + 1] = static_cast<float>(vals[iy]);
    out->points[row * 3 + 2] = static_cast<float>(vals[iz]);
    if (out->intensity) out->intensity[row] = static_cast<float>(vals[ii]);
    if (out->normals) {
      out->normals[row * 3 + 0] = static_cast<float>(vals[inx]);
      out->normals[row * 3 + 1] = static_cast<float>(vals[iny]);
      out->normals[row * 3 + 2] = static_cast<float>(vals[inz]);
    }
    if (out->rgb) {
      const float scale = props[ir].kind == 'f' ? 1.0f : (1.0f / 255.0f);
      out->rgb[row * 4 + 0] = static_cast<float>(vals[ir]) * scale;
      out->rgb[row * 4 + 1] = static_cast<float>(vals[ig]) * scale;
      out->rgb[row * 4 + 2] = static_cast<float>(vals[ib]) * scale;
      out->rgb[row * 4 + 3] = ia >= 0 ? static_cast<float>(vals[ia]) * scale : 1.0f;
    }
    if (out->timestamps) out->timestamps[row] = static_cast<float>(vals[it]);
  };

  if (format == "ascii") {
    std::vector<double> vals(props.size());
    for (int64_t row = 0; row < n; ++row) {
      for (size_t k = 0; k < props.size(); ++k)
        if (!(f >> vals[k])) return fail(out, "truncated ASCII body");
      emit(row, vals);
    }
  } else if (format == "binary_little_endian") {
    size_t stride = 0;
    std::vector<size_t> offs(props.size());
    for (size_t k = 0; k < props.size(); ++k) {
      offs[k] = stride;
      stride += props[k].size;
    }
    std::vector<uint8_t> buf(stride * static_cast<size_t>(n));
    f.read(reinterpret_cast<char*>(buf.data()), static_cast<std::streamsize>(buf.size()));
    if (static_cast<size_t>(f.gcount()) < buf.size()) return fail(out, "truncated binary body");
    std::vector<double> vals(props.size());
    for (int64_t row = 0; row < n; ++row) {
      const uint8_t* rec = buf.data() + static_cast<size_t>(row) * stride;
      for (size_t k = 0; k < props.size(); ++k)
        vals[k] = read_scalar(rec + offs[k], props[k]);
      emit(row, vals);
    }
  } else {
    return fail(out, "unsupported PLY format");
  }

  out->n = n;
  out->ok = 1;
  return out;
}

SptCloud* spt_read_kitti_bin(const char* path) {
  auto* out = new SptCloud();
  std::ifstream f(path, std::ios::binary | std::ios::ate);
  if (!f) return fail(out, "cannot open file");
  const int64_t bytes = static_cast<int64_t>(f.tellg());
  const int64_t n = bytes / (4 * sizeof(float));
  f.seekg(0);
  std::vector<float> buf(static_cast<size_t>(n) * 4);
  f.read(reinterpret_cast<char*>(buf.data()), n * 4 * sizeof(float));
  out->points = static_cast<float*>(std::malloc(sizeof(float) * 3 * n));
  out->intensity = static_cast<float*>(std::malloc(sizeof(float) * n));
  for (int64_t i = 0; i < n; ++i) {
    out->points[i * 3 + 0] = buf[i * 4 + 0];
    out->points[i * 3 + 1] = buf[i * 4 + 1];
    out->points[i * 3 + 2] = buf[i * 4 + 2];
    out->intensity[i] = buf[i * 4 + 3];
  }
  out->n = n;
  out->ok = 1;
  return out;
}

// ---------------------------------------------------------------------------
// Prefetching sequence loader: a reader thread parses scans ahead of the
// consumer so host I/O overlaps device compute.
// ---------------------------------------------------------------------------

struct SptLoader {
  std::vector<std::string> paths;
  size_t next_submit = 0;
  size_t capacity = 2;
  std::deque<SptCloud*> ready;
  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  std::thread worker;
  std::atomic<bool> stop{false};

  void run() {
    while (!stop.load()) {
      size_t idx;
      {
        std::unique_lock<std::mutex> lk(mu);
        if (next_submit >= paths.size()) break;
        cv_space.wait(lk, [&] { return ready.size() < capacity || stop.load(); });
        if (stop.load()) break;
        idx = next_submit++;
      }
      const std::string& p = paths[idx];
      SptCloud* c = nullptr;
      if (p.size() > 4 && p.substr(p.size() - 4) == ".ply")
        c = spt_read_ply(p.c_str());
      else
        c = spt_read_kitti_bin(p.c_str());
      {
        std::lock_guard<std::mutex> lk(mu);
        ready.push_back(c);
      }
      cv_ready.notify_one();
    }
  }
};

void* spt_loader_open(const char** paths, int n_paths, int n_prefetch) {
  auto* l = new SptLoader();
  l->paths.assign(paths, paths + n_paths);
  l->capacity = n_prefetch > 0 ? static_cast<size_t>(n_prefetch) : 2;
  l->worker = std::thread([l] { l->run(); });
  return l;
}

SptCloud* spt_loader_next(void* handle) {
  auto* l = static_cast<SptLoader*>(handle);
  std::unique_lock<std::mutex> lk(l->mu);
  const bool more_coming = l->next_submit < l->paths.size() || !l->ready.empty();
  if (!more_coming && l->ready.empty()) return nullptr;
  l->cv_ready.wait(lk, [&] { return !l->ready.empty(); });
  SptCloud* c = l->ready.front();
  l->ready.pop_front();
  l->cv_space.notify_one();
  return c;
}

void spt_loader_close(void* handle) {
  auto* l = static_cast<SptLoader*>(handle);
  l->stop.store(true);
  l->cv_space.notify_all();
  l->cv_ready.notify_all();
  if (l->worker.joinable()) l->worker.join();
  for (auto* c : l->ready) spt_free_cloud(c);
  delete l;
}

}  // extern "C"

// ---- liblzf-compatible codec (PCL binary_compressed PCD payloads) ---------
//
// Stream grammar (public liblzf format; the pure-Python mirror lives in
// points/io.py): control byte < 32 -> literal run of ctrl+1 bytes;
// otherwise a back-reference of (ctrl >> 5) + 2 bytes (7 extends the length
// by the next byte) at distance ((ctrl & 0x1f) << 8 | next) + 1.  The pure
// Python decode runs at ~1 MB/s, far too slow for streaming real
// binary_compressed scans; this native codec is the hot path and the
// Python one stays as the fallback.

#include <algorithm>

extern "C" {

int64_t spt_lzf_decompress(const uint8_t* src, int64_t src_len,
                           uint8_t* dst, int64_t dst_cap) {
  int64_t i = 0, o = 0;
  while (i < src_len && o < dst_cap) {
    const uint32_t ctrl = src[i++];
    if (ctrl < 32) {
      const int64_t cnt = (int64_t)ctrl + 1;
      if (i + cnt > src_len || o + cnt > dst_cap) return -1;
      std::memcpy(dst + o, src + i, (size_t)cnt);
      i += cnt;
      o += cnt;
    } else {
      int64_t len = ctrl >> 5;
      if (len == 7) {
        if (i >= src_len) return -1;
        len += src[i++];
      }
      len += 2;
      if (i >= src_len) return -1;
      const int64_t ref = o - ((((int64_t)ctrl & 0x1f) << 8) | src[i++]) - 1;
      if (ref < 0 || o + len > dst_cap) return -1;
      // overlap-capable by definition: byte-serial copy
      for (int64_t k = 0; k < len; ++k) dst[o + k] = dst[ref + k];
      o += len;
    }
  }
  return o;
}

int64_t spt_lzf_compress(const uint8_t* src, int64_t n,
                         uint8_t* dst, int64_t dst_cap) {
  // Greedy 3-byte-hash compressor.  Unlike the Python mirror's exact
  // dict it uses a 16-bit hash bucket (candidate bytes are re-verified),
  // so the two compressors may emit different but equally valid streams.
  constexpr int64_t kMaxDist = 1 << 13;
  constexpr int64_t kMaxLen = 264;
  std::vector<int64_t> table((size_t)1 << 16, -1);
  int64_t o = 0, i = 0, lit_start = 0;

  auto flush_literals = [&](int64_t end) -> bool {
    for (int64_t s = lit_start; s < end;) {
      const int64_t run = std::min<int64_t>(32, end - s);
      if (o + 1 + run > dst_cap) return false;
      dst[o++] = (uint8_t)(run - 1);
      std::memcpy(dst + o, src + s, (size_t)run);
      o += run;
      s += run;
    }
    return true;
  };

  while (i < n) {
    if (i + 3 <= n) {
      const uint32_t v = (uint32_t)src[i] | ((uint32_t)src[i + 1] << 8) |
                         ((uint32_t)src[i + 2] << 16);
      const uint32_t h = (v * 2654435761u) >> 16;
      const int64_t cand = table[h];
      table[h] = i;
      const int64_t dist = i - cand - 1;
      if (cand >= 0 && dist < kMaxDist && src[cand] == src[i] &&
          src[cand + 1] == src[i + 1] && src[cand + 2] == src[i + 2]) {
        int64_t len = 3;
        const int64_t max_len = std::min<int64_t>(n - i, kMaxLen);
        while (len < max_len && src[cand + len] == src[i + len]) ++len;
        if (!flush_literals(i)) return -1;
        const int64_t l_enc = len - 2;
        if (o + 3 > dst_cap) return -1;
        if (l_enc < 7) {
          dst[o++] = (uint8_t)((l_enc << 5) | (dist >> 8));
        } else {
          dst[o++] = (uint8_t)((7u << 5) | (dist >> 8));
          dst[o++] = (uint8_t)(l_enc - 7);
        }
        dst[o++] = (uint8_t)(dist & 0xff);
        i += len;
        lit_start = i;
        continue;
      }
    }
    ++i;
  }
  if (!flush_literals(n)) return -1;
  return o;
}

}  // extern "C"
