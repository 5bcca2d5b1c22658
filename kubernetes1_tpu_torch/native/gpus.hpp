// The node's cards, as the native GPU plugin and exporter both see them:
// the discovery of the Python GPUDevicePlugin (deviceplugin/gpu_plugin.py),
// with one NVML pass in place of nvidia-smi, so that each binary names a
// card exactly as the Python plugin does.
//
//   fake mode: KTPU_FAKE_GPUS="<model>:<count>:<domain>:<host>[:<MiB>]"
//              (the Python plugin's defaults for each empty field);
//   real mode: every card NVML reports, at its own node /dev/nvidia<minor>
//              (the minor from NVML, never from the order of /dev
//              entries), advertised only where that node exists.
#pragma once

#include <stdlib.h>
#include <sys/stat.h>
#include <unistd.h>

#include <string>
#include <vector>

#include "nvml.hpp"

namespace ktpu {

constexpr const char* kFakeModel = "NVIDIA H100 80GB HBM3";
constexpr const char* kFakeMemoryMiB = "81559";

struct Card {
  std::string id;
  std::string model;
  std::string memory_mib;
  std::string uuid;
  std::string domain;  // the NVLink domain: the host name in real mode
  std::string index;   // NVML's index, or the position in fake mode
  std::string path;    // /dev/nvidia<minor>; empty in fake mode
  nvml::nvmlDevice_t handle = nullptr;  // real mode
};

inline std::string getenv_or(const char* name, const std::string& dflt) {
  const char* v = getenv(name);
  return v && *v ? std::string(v) : dflt;
}

inline std::vector<std::string> split(const std::string& s, char sep) {
  std::vector<std::string> out;
  std::string cur;
  for (char c : s) {
    if (c == sep) {
      out.push_back(cur);
      cur.clear();
    } else {
      cur += c;
    }
  }
  out.push_back(cur);
  return out;
}

inline std::string host_name() {
  char name[256] = "";
  gethostname(name, sizeof name);
  name[sizeof name - 1] = 0;
  return name;
}

inline bool node_exists(const std::string& path) {
  struct stat st;
  return stat(path.c_str(), &st) == 0;
}

inline std::vector<Card> fake_cards(const std::string& spec) {
  auto parts = split(spec, ':');
  auto part = [&](size_t i, const char* dflt) {
    return parts.size() > i && !parts[i].empty() ? parts[i] : std::string(dflt);
  };
  std::string model = part(0, kFakeModel), domain = part(2, "nvlink-0"),
              host = part(3, "0"), memory = part(4, kFakeMemoryMiB);
  int count = atoi(part(1, "1").c_str());
  std::vector<Card> cards;
  for (int i = 0; i < count; ++i) {
    Card c;
    c.id = domain + "-h" + host + "-gpu" + std::to_string(i);
    c.model = model;
    c.memory_mib = memory;
    c.uuid = "GPU-fake-" + domain + "-h" + host + "-" + std::to_string(i);
    c.domain = domain;
    c.index = std::to_string(i);
    cards.push_back(c);
  }
  return cards;
}

inline std::vector<Card> real_cards(nvml::Library& lib) {
  std::vector<Card> cards;
  unsigned int count = 0;
  if (lib.DeviceGetCount(&count) != nvml::kSuccess) return cards;
  std::string host = host_name();
  for (unsigned int i = 0; i < count; ++i) {
    Card c;
    unsigned int minor = 0;
    if (lib.DeviceGetHandleByIndex(i, &c.handle) != nvml::kSuccess ||
        lib.DeviceGetMinorNumber(c.handle, &minor) != nvml::kSuccess)
      continue;
    c.path = "/dev/nvidia" + std::to_string(minor);
    if (!node_exists(c.path)) continue;
    char buf[nvml::kStringBuffer] = "";
    if (lib.DeviceGetUUID(c.handle, buf, sizeof buf) == nvml::kSuccess) c.uuid = buf;
    buf[0] = 0;
    if (lib.DeviceGetName(c.handle, buf, sizeof buf) == nvml::kSuccess) c.model = buf;
    nvml::nvmlMemory_t mem{};
    if (lib.DeviceGetMemoryInfo(c.handle, &mem) == nvml::kSuccess)
      c.memory_mib = std::to_string(mem.total / (1024ull * 1024ull));
    c.id = host + "-nvidia" + std::to_string(minor);
    c.domain = host;
    c.index = std::to_string(i);
    cards.push_back(c);
  }
  return cards;
}

// The node's cards: fake mode when KTPU_FAKE_GPUS is set, else NVML's.
// ``lib`` is opened in real mode only; false (with ``why``) when NVML
// cannot be used there.
inline bool discover(nvml::Library& lib, std::vector<Card>* cards, std::string* why) {
  std::string fake = getenv_or("KTPU_FAKE_GPUS", "");
  if (!fake.empty()) {
    *cards = fake_cards(fake);
    return true;
  }
  if (!lib.open(why)) return false;
  *cards = real_cards(lib);
  return true;
}

}  // namespace ktpu
