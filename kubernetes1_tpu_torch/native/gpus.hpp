// The node's cards, as the native GPU plugin and exporter both see them:
// the discovery of the Python GPUDevicePlugin (deviceplugin/gpu_plugin.py),
// with one NVML pass in place of nvidia-smi, so that each binary names a
// card exactly as the Python plugin does.
//
//   fake mode: KTPU_FAKE_GPUS="<model>:<count>:<domain>:<host>[:<MiB>]"
//              (the Python plugin's defaults for each empty field; the
//              domain one name for every card, or one a card,
//              comma-separated, cards past the list taking its last);
//   real mode: every card NVML reports, at its own node /dev/nvidia<minor>
//              (the minor from NVML, never from the order of /dev
//              entries; KTPU_DEV_DIR in place of /dev, for tests),
//              advertised only where that node exists, in its NVLink
//              domain: the connected component of the NVLink peer graph
//              (nvmlDeviceGetP2PStatus) that holds it, named
//              <host>-nvl<lowest minor in it>; a card alone, or every
//              card where the call is missing, is a domain of its own.
#pragma once

#include <stdlib.h>
#include <sys/stat.h>
#include <unistd.h>

#include <algorithm>
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
  std::string domain;  // the NVLink domain
  std::string coords;  // the position in it: the minor, or the index in fake mode
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
  std::string model = part(0, kFakeModel), host = part(3, "0"),
              memory = part(4, kFakeMemoryMiB);
  std::vector<std::string> domains = split(part(2, "nvlink-0"), ',');
  int count = atoi(part(1, "1").c_str());
  std::vector<Card> cards;
  for (int i = 0; i < count; ++i) {
    const std::string& domain = domains[std::min<size_t>(i, domains.size() - 1)];
    Card c;
    c.id = domain + "-h" + host + "-gpu" + std::to_string(i);
    c.model = model;
    c.memory_mib = memory;
    c.uuid = "GPU-fake-" + domain + "-h" + host + "-" + std::to_string(i);
    c.domain = domain;
    c.coords = std::to_string(i);
    c.index = std::to_string(i);
    cards.push_back(c);
  }
  return cards;
}

// Each card's NVLink domain, by union-find over the cards' NVLink pairs.
inline void nvlink_domains(nvml::Library& lib, const std::string& host,
                           const std::vector<unsigned int>& minors, std::vector<Card>* cards) {
  size_t n = cards->size();
  std::vector<size_t> root(n);
  for (size_t i = 0; i < n; ++i) root[i] = i;
  auto find = [&](size_t i) {
    while (root[i] != i) i = root[i] = root[root[i]];
    return i;
  };
  for (size_t i = 0; i < n && lib.DeviceGetP2PStatus != nullptr; ++i)
    for (size_t j = i + 1; j < n; ++j) {
      int status = -1;
      if (lib.DeviceGetP2PStatus((*cards)[i].handle, (*cards)[j].handle,
                                 nvml::kP2PCapsIndexNvlink, &status) == nvml::kSuccess &&
          status == nvml::kP2PStatusOk)
        root[find(i)] = find(j);
    }
  std::vector<unsigned int> low(n, ~0u);
  for (size_t i = 0; i < n; ++i) low[find(i)] = std::min(low[find(i)], minors[i]);
  for (size_t i = 0; i < n; ++i) (*cards)[i].domain = host + "-nvl" + std::to_string(low[find(i)]);
}

inline std::vector<Card> real_cards(nvml::Library& lib) {
  std::vector<Card> cards;
  std::vector<unsigned int> minors;
  unsigned int count = 0;
  if (lib.DeviceGetCount(&count) != nvml::kSuccess) return cards;
  std::string host = host_name(), dev_dir = getenv_or("KTPU_DEV_DIR", "/dev");
  for (unsigned int i = 0; i < count; ++i) {
    Card c;
    unsigned int minor = 0;
    if (lib.DeviceGetHandleByIndex(i, &c.handle) != nvml::kSuccess ||
        lib.DeviceGetMinorNumber(c.handle, &minor) != nvml::kSuccess)
      continue;
    c.path = dev_dir + "/nvidia" + std::to_string(minor);
    char buf[nvml::kStringBuffer] = "";
    if (lib.DeviceGetUUID(c.handle, buf, sizeof buf) == nvml::kSuccess) c.uuid = buf;
    buf[0] = 0;
    if (lib.DeviceGetName(c.handle, buf, sizeof buf) == nvml::kSuccess) c.model = buf;
    nvml::nvmlMemory_t mem{};
    if (lib.DeviceGetMemoryInfo(c.handle, &mem) == nvml::kSuccess)
      c.memory_mib = std::to_string(mem.total / (1024ull * 1024ull));
    c.id = host + "-nvidia" + std::to_string(minor);
    c.coords = std::to_string(minor);
    c.index = std::to_string(i);
    cards.push_back(c);
    minors.push_back(minor);
  }
  // the domains span every card NVML reports; only those with a node here
  // are advertised
  nvlink_domains(lib, host, minors, &cards);
  std::vector<Card> present;
  for (const auto& c : cards)
    if (node_exists(c.path)) present.push_back(c);
  return present;
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
