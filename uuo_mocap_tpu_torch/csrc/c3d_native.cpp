// Native C3D reader and threaded sequence prefetcher.
//
// The port's copy of cpp/c3d_native.cpp:
//   * a C3D parser (Intel format, float/int point data, POINT parameters)
//     exposed through a plain C ABI for ctypes;
//   * a thread-pool prefetcher that parses upcoming sequence files while
//     the GPU solves the current one.
//
// Built with the host C++ compiler on first use by
// uuo_mocap_tpu_torch/data/c3d_native.py, into uuo_mocap_tpu_torch/_build/.
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <functional>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr size_t kBlock = 512;
constexpr int kProcIntel = 84;

struct C3dData {
  std::vector<float> points;  // [F * M * 4]
  int frames = 0;
  int markers = 0;
  float rate = 0.f;
  char units[16] = "mm";
  std::vector<std::string> labels;
  std::string error;
};

template <typename T>
T ReadLE(const uint8_t* p) {
  T v;
  std::memcpy(&v, p, sizeof(T));
  return v;  // assumes little-endian host (x86/arm LE)
}

bool ParseC3d(const std::string& path, C3dData* out) {
  FILE* f = std::fopen(path.c_str(), "rb");
  if (!f) {
    out->error = "cannot open " + path;
    return false;
  }
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> raw(size);
  if (std::fread(raw.data(), 1, size, f) != static_cast<size_t>(size)) {
    std::fclose(f);
    out->error = "short read";
    return false;
  }
  std::fclose(f);
  if (size < static_cast<long>(kBlock) || raw[1] != 0x50) {
    out->error = "not a C3D file";
    return false;
  }

  int param_block = raw[0];
  int num_points = ReadLE<uint16_t>(&raw[2]);
  int analog_per_frame = ReadLE<uint16_t>(&raw[4]);
  int first_frame = ReadLE<uint16_t>(&raw[6]);
  int last_frame = ReadLE<uint16_t>(&raw[8]);
  float scale = ReadLE<float>(&raw[12]);
  int data_block = ReadLE<uint16_t>(&raw[16]);
  float rate = ReadLE<float>(&raw[20]);
  int num_frames = last_frame - first_frame + 1;

  // ---- parameter section
  size_t p0 = (param_block - 1) * kBlock;
  if (p0 + 4 > raw.size() || raw[p0 + 3] != kProcIntel) {
    out->error = "unsupported processor type";
    return false;
  }
  std::map<int, std::string> group_names;
  struct Param {
    int dtype;
    std::vector<int> dims;
    std::vector<uint8_t> data;
  };
  std::map<int, std::map<std::string, Param>> params;

  size_t pos = p0 + 4;
  while (pos + 2 < raw.size()) {
    int8_t name_len = static_cast<int8_t>(raw[pos]);
    if (name_len == 0) break;
    int8_t gid = static_cast<int8_t>(raw[pos + 1]);
    int nlen = name_len < 0 ? -name_len : name_len;
    std::string name(reinterpret_cast<const char*>(&raw[pos + 2]), nlen);
    size_t pos2 = pos + 2 + nlen;
    if (pos2 + 2 > raw.size()) break;
    int16_t offset = ReadLE<int16_t>(&raw[pos2]);
    if (gid < 0) {
      group_names[-gid] = name;
    } else {
      if (pos2 + 4 > raw.size()) break;
      int dtype = static_cast<int8_t>(raw[pos2 + 2]);
      int ndims = raw[pos2 + 3];
      std::vector<int> dims;
      size_t count = 1;
      for (int d = 0; d < ndims; ++d) {
        dims.push_back(raw[pos2 + 4 + d]);
        count *= dims.back();
      }
      size_t esize = dtype == -1 || dtype == 1 ? 1 : (dtype == 2 ? 2 : 4);
      size_t dstart = pos2 + 4 + ndims;
      Param p;
      p.dtype = dtype;
      p.dims = dims;
      if (dstart + count * esize <= raw.size()) {
        p.data.assign(raw.begin() + dstart, raw.begin() + dstart + count * esize);
      }
      params[gid][name] = std::move(p);
    }
    if (offset <= 0) break;
    pos = pos2 + offset;
  }

  auto get_param = [&](const std::string& group, const std::string& name) -> Param* {
    for (auto& [gid, gname] : group_names) {
      if (gname == group) {
        auto git = params.find(gid);
        if (git != params.end()) {
          auto pit = git->second.find(name);
          if (pit != git->second.end()) return &pit->second;
        }
      }
    }
    return nullptr;
  };

  if (Param* p = get_param("POINT", "USED")) {
    if (p->dtype == 2 && p->data.size() >= 2) num_points = ReadLE<int16_t>(p->data.data());
  }
  if (Param* p = get_param("POINT", "RATE")) {
    if (p->dtype == 4 && p->data.size() >= 4) rate = ReadLE<float>(p->data.data());
  }
  if (Param* p = get_param("POINT", "SCALE")) {
    if (p->dtype == 4 && p->data.size() >= 4) scale = ReadLE<float>(p->data.data());
  }
  if (Param* p = get_param("POINT", "FRAMES")) {
    if (p->dtype == 2 && p->data.size() >= 2) {
      // a signed 16-bit word, written as 32767 for longer captures; the
      // header's unsigned count (up to 65535 frames) then takes over
      int v = ReadLE<int16_t>(p->data.data());
      if (v > 0 && !(v == 32767 && num_frames > v)) num_frames = v;
    }
  }
  if (Param* p = get_param("POINT", "UNITS")) {
    if (p->dtype == -1 && !p->data.empty()) {
      size_t n = std::min(p->data.size(), sizeof(out->units) - 1);
      std::memcpy(out->units, p->data.data(), n);
      out->units[n] = 0;
      for (int i = static_cast<int>(n) - 1; i >= 0 && out->units[i] == ' '; --i) out->units[i] = 0;
    }
  }
  if (Param* p = get_param("POINT", "LABELS")) {
    if (p->dtype == -1 && p->dims.size() == 2) {
      int w = p->dims[0], n = p->dims[1];
      for (int i = 0; i < n && (i + 1) * w <= static_cast<int>(p->data.size()); ++i) {
        std::string label(reinterpret_cast<const char*>(&p->data[i * w]), w);
        while (!label.empty() && label.back() == ' ') label.pop_back();
        out->labels.push_back(label);
      }
    }
  }

  // ---- point data
  size_t d0 = (data_block - 1) * kBlock;
  bool is_float = scale < 0;
  size_t values_per_frame = static_cast<size_t>(num_points) * 4 + analog_per_frame;
  // validate BEFORE the avail computation: d0 past EOF would underflow
  // raw.size()-d0 (size_t) into a huge frame count, and values_per_frame==0
  // would divide by zero
  if (num_points <= 0 || values_per_frame == 0) {
    out->error = "no point data (POINT:USED == 0)";
    return false;
  }
  if (data_block <= 0 || d0 >= raw.size()) {
    out->error = "data block offset past end of file";
    return false;
  }
  if (num_frames < 0) num_frames = 0;
  size_t need = values_per_frame * static_cast<size_t>(num_frames) * (is_float ? 4 : 2);
  if (d0 + need > raw.size()) {
    // clamp frames to what is actually present
    size_t avail = (raw.size() - d0) / (values_per_frame * (is_float ? 4 : 2));
    num_frames = static_cast<int>(avail);
  }

  out->frames = num_frames;
  out->markers = num_points;
  out->rate = rate;
  out->points.resize(static_cast<size_t>(num_frames) * num_points * 4);
  for (int fr = 0; fr < num_frames; ++fr) {
    const uint8_t* base = &raw[d0 + fr * values_per_frame * (is_float ? 4 : 2)];
    for (int m = 0; m < num_points; ++m) {
      for (int k = 0; k < 4; ++k) {
        float v;
        if (is_float) {
          v = ReadLE<float>(base + (m * 4 + k) * 4);
        } else {
          v = static_cast<float>(ReadLE<int16_t>(base + (m * 4 + k) * 2));
          if (k < 3) v *= std::abs(scale);
        }
        out->points[(static_cast<size_t>(fr) * num_points + m) * 4 + k] = v;
      }
    }
  }
  return true;
}

// ------------------------------------------------------------------ prefetch
struct Prefetcher {
  std::vector<std::thread> workers;
  std::deque<std::string> queue;
  std::map<std::string, C3dData*> ready;
  std::mutex mu;
  std::condition_variable cv_work;
  std::condition_variable cv_done;
  bool stop = false;

  explicit Prefetcher(int n_threads) {
    for (int i = 0; i < n_threads; ++i) {
      workers.emplace_back([this] { Run(); });
    }
  }

  ~Prefetcher() {
    {
      std::lock_guard<std::mutex> lock(mu);
      stop = true;
    }
    cv_work.notify_all();
    for (auto& t : workers) t.join();
    for (auto& [k, v] : ready) delete v;
  }

  void Run() {
    for (;;) {
      std::string path;
      {
        std::unique_lock<std::mutex> lock(mu);
        cv_work.wait(lock, [this] { return stop || !queue.empty(); });
        if (stop) return;
        path = queue.front();
        queue.pop_front();
      }
      auto* data = new C3dData();
      // an uncaught exception (e.g. bad_alloc on a corrupt file) in a worker
      // thread would std::terminate the whole process — record it instead
      try {
        ParseC3d(path, data);
      } catch (const std::exception& e) {
        data->error = std::string("parse exception: ") + e.what();
      } catch (...) {
        data->error = "parse exception (unknown)";
      }
      {
        std::lock_guard<std::mutex> lock(mu);
        ready[path] = data;
      }
      cv_done.notify_all();
    }
  }

  void Enqueue(const std::string& path) {
    {
      std::lock_guard<std::mutex> lock(mu);
      if (ready.count(path)) return;
      queue.push_back(path);
    }
    cv_work.notify_one();
  }

  C3dData* Wait(const std::string& path) {
    std::unique_lock<std::mutex> lock(mu);
    cv_done.wait(lock, [this, &path] { return ready.count(path) > 0; });
    C3dData* d = ready[path];
    ready.erase(path);
    return d;
  }
};

}  // namespace

extern "C" {

// ---- single-file API
void* uuoc3d_read(const char* path) {
  auto* data = new C3dData();
  if (!ParseC3d(path, data)) {
    // keep object; caller checks uuoc3d_error
  }
  return data;
}

const char* uuoc3d_error(void* handle) {
  auto* d = static_cast<C3dData*>(handle);
  return d->error.empty() ? nullptr : d->error.c_str();
}

int uuoc3d_frames(void* handle) { return static_cast<C3dData*>(handle)->frames; }
int uuoc3d_markers(void* handle) { return static_cast<C3dData*>(handle)->markers; }
float uuoc3d_rate(void* handle) { return static_cast<C3dData*>(handle)->rate; }
const char* uuoc3d_units(void* handle) { return static_cast<C3dData*>(handle)->units; }
const float* uuoc3d_points(void* handle) { return static_cast<C3dData*>(handle)->points.data(); }

int uuoc3d_num_labels(void* handle) {
  return static_cast<int>(static_cast<C3dData*>(handle)->labels.size());
}
const char* uuoc3d_label(void* handle, int i) {
  auto* d = static_cast<C3dData*>(handle);
  if (i < 0 || i >= static_cast<int>(d->labels.size())) return "";
  return d->labels[i].c_str();
}

void uuoc3d_free(void* handle) { delete static_cast<C3dData*>(handle); }

// ---- prefetcher API
void* uuoc3d_prefetcher_create(int n_threads) { return new Prefetcher(n_threads); }
void uuoc3d_prefetcher_enqueue(void* p, const char* path) {
  static_cast<Prefetcher*>(p)->Enqueue(path);
}
void* uuoc3d_prefetcher_wait(void* p, const char* path) {
  return static_cast<Prefetcher*>(p)->Wait(path);
}
void uuoc3d_prefetcher_destroy(void* p) { delete static_cast<Prefetcher*>(p); }

}  // extern "C"
