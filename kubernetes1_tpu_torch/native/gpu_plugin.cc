// ktpu-gpu-plugin: the native nvidia.com/gpu device plugin.
//
// The 4-RPC device-plugin protocol (deviceplugin/api.py): GetPluginInfo,
// ListAndWatch (stream), AdmitPod and InitContainer, as newline-delimited
// JSON frames over a unix socket at <plugin-dir>/nvidia.com/gpu.sock.  It
// has the semantics of the Python GPUDevicePlugin
// (deviceplugin/gpu_plugin.py): the same inventory (gpus.hpp), the same
// admission and the same injection (CUDA_VISIBLE_DEVICES and the card's
// /dev/nvidia* nodes, the torch.distributed env from the worker-id,
// coordinator-address and worker-hostnames annotations: the gpu.ktpu.io/
// keys, else the tpu.ktpu.io/ keys the Job controller stamps), plus the
// annotation gpu.ktpu.io/plugin: native; no Python runtime is needed on
// the node.  In real mode it exits non-zero when NVML
// cannot be used, rather than advertise nothing.  SIGTERM or SIGINT
// unlinks the socket and exits 0.
//
//   ktpu-gpu-plugin [--plugin-dir D]      (default $KTPU_PLUGIN_DIR or
//                                          /var/lib/ktpu/device-plugins)
//
// Build: make -C kubernetes1_tpu_torch/native

#include <errno.h>
#include <pthread.h>
#include <signal.h>
#include <stdio.h>
#include <string.h>
#include <sys/socket.h>
#include <sys/stat.h>
#include <sys/un.h>
#include <unistd.h>

#include <atomic>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include "gpus.hpp"
#include "json.hpp"

using ktpu::Card;
using ktpu::Json;
using ktpu::JsonArray;
using ktpu::JsonObject;

namespace {

constexpr const char* kResource = "nvidia.com/gpu";
constexpr const char* kHealthy = "Healthy";
constexpr const char* kUnhealthy = "Unhealthy";

constexpr const char* kAttrModel = "nvidia.com/gpu/model";
constexpr const char* kAttrMemory = "nvidia.com/gpu/memory";
constexpr const char* kAttrUuid = "nvidia.com/gpu/uuid";
constexpr const char* kAttrNvlinkDomain = "nvidia.com/gpu/nvlink-domain";
// the card's minor (its index in fake mode): with the NVLink domain, what
// the port's scheduler picks cards by
constexpr const char* kAttrMinor = "nvidia.com/gpu/minor";
// the same two, under the keys the JAX scheduler's slice-aware allocation
// reads: the card's interconnect domain and its position in it (the JAX
// package's strings, copied)
constexpr const char* kAttrSlice = "google.com/tpu/slice";
constexpr const char* kAttrCoords = "google.com/tpu/coords";
constexpr const char* kAttrDeviceIndex = "ktpu.io/device-index";
constexpr const char* kAttrDevicePath = "ktpu.io/device-path";

constexpr const char* kAnnWorkerId = "gpu.ktpu.io/worker-id";
constexpr const char* kAnnCoordinator = "gpu.ktpu.io/coordinator-address";
constexpr const char* kAnnWorkerHostnames = "gpu.ktpu.io/worker-hostnames";
// what the Job controller stamps on each pod of an Indexed Job (the JAX
// package's strings, copied); the gpu.ktpu.io keys take precedence
constexpr const char* kJobAnnWorkerId = "tpu.ktpu.io/worker-id";
constexpr const char* kJobAnnCoordinator = "tpu.ktpu.io/coordinator-address";
constexpr const char* kJobAnnWorkerHostnames = "tpu.ktpu.io/worker-hostnames";

// The NVIDIA control nodes a CUDA process opens besides its card's.
const char* const kControlNodes[] = {"/dev/nvidiactl", "/dev/nvidia-uvm",
                                     "/dev/nvidia-uvm-tools"};

constexpr int kHealthCheckSeconds = 10;

struct Device {
  Card card;
  std::string health = kHealthy;

  Json to_json() const {
    JsonObject attrs;
    attrs[kAttrModel] = Json(card.model);
    attrs[kAttrMemory] = Json(card.memory_mib);
    attrs[kAttrUuid] = Json(card.uuid);
    attrs[kAttrNvlinkDomain] = Json(card.domain);
    attrs[kAttrMinor] = Json(card.coords);
    attrs[kAttrSlice] = Json(card.domain);
    attrs[kAttrCoords] = Json(card.coords);
    attrs[kAttrDeviceIndex] = Json(card.index);
    if (!card.path.empty()) attrs[kAttrDevicePath] = Json(card.path);
    JsonObject o;
    o["id"] = Json(card.id);
    o["health"] = Json(health);
    o["attributes"] = Json(attrs);
    return Json(o);
  }
};

JsonObject device_spec(const std::string& path) {
  JsonObject ds;
  ds["host_path"] = Json(path);
  ds["container_path"] = Json(path);
  ds["permissions"] = Json("rw");
  return ds;
}

class GPUPlugin {
 public:
  explicit GPUPlugin(const std::vector<Card>& cards) {
    for (const auto& c : cards) devices_.push_back(Device{c});
  }

  size_t device_count() const { return devices_.size(); }

  Json get_plugin_info() {
    JsonObject o;
    o["name"] = Json(kResource);
    o["version"] = Json("v1");
    o["device_count"] = Json(static_cast<int64_t>(devices_.size()));
    o["native"] = Json(true);
    return Json(o);
  }

  Json list_devices() {
    std::lock_guard<std::mutex> lock(mu_);
    JsonArray arr;
    for (const auto& d : devices_) arr.push_back(d.to_json());
    return Json(arr);
  }

  // Real mode: a vanished /dev/nvidiaN marks its card unhealthy (and a
  // node that comes back, healthy).  True when any health flipped.
  bool check_health() {
    std::lock_guard<std::mutex> lock(mu_);
    bool changed = false;
    for (auto& d : devices_) {
      if (d.card.path.empty()) continue;
      std::string want = ktpu::node_exists(d.card.path) ? kHealthy : kUnhealthy;
      if (d.health != want) {
        d.health = want;
        changed = true;
      }
    }
    return changed;
  }

  // The scheduler's assignment against this node's cards.
  Json admit_pod(const Json& params) {
    std::lock_guard<std::mutex> lock(mu_);
    JsonObject resp;
    const Json& assignments = params["assignments"];
    if (assignments.is_object()) {
      for (const auto& kv : assignments.as_object()) {
        if (!kv.second.is_array()) continue;
        for (const auto& idj : kv.second.as_array()) {
          const std::string& id = idj.as_string();
          const Device* dev = find(id);
          if (dev == nullptr || dev->health != kHealthy) {
            resp["allowed"] = Json(false);
            resp["reason"] =
                Json("device " + id + (dev == nullptr ? " not on this node" : " unhealthy"));
            return Json(resp);
          }
        }
      }
    }
    resp["allowed"] = Json(true);
    return Json(resp);
  }

  // What one container of the pod gets: its cards' env and nodes.
  Json init_container(const Json& params) {
    JsonObject envs;
    JsonArray dev_specs;
    std::vector<std::string> visible;
    {
      std::lock_guard<std::mutex> lock(mu_);
      if (params["device_ids"].is_array()) {
        for (const auto& idj : params["device_ids"].as_array()) {
          const Device* dev = find(idj.as_string());
          if (dev == nullptr) continue;
          if (!dev->card.path.empty()) {
            visible.push_back(!dev->card.uuid.empty() ? dev->card.uuid : dev->card.index);
            dev_specs.push_back(Json(device_spec(dev->card.path)));
          } else {
            visible.push_back(dev->card.index);
          }
        }
      }
    }
    if (!dev_specs.empty()) {
      for (const char* node : kControlNodes)
        if (ktpu::node_exists(node)) dev_specs.push_back(Json(device_spec(node)));
    }
    std::string joined;
    for (size_t i = 0; i < visible.size(); ++i) joined += (i ? "," : "") + visible[i];
    envs["CUDA_VISIBLE_DEVICES"] = Json(joined);
    envs["NVIDIA_VISIBLE_DEVICES"] = Json(joined);
    envs["CUDA_DEVICE_ORDER"] = Json("PCI_BUS_ID");
    const Json& anns = params["pod_annotations"];
    if (anns.is_object()) {
      // the annotation under ``key``, else under ``job_key``; null when neither is a string
      auto either = [&](const char* key, const char* job_key) -> const Json* {
        if (anns[key].is_string()) return &anns[key];
        if (anns[job_key].is_string()) return &anns[job_key];
        return nullptr;
      };
      if (const Json* id = either(kAnnWorkerId, kJobAnnWorkerId)) {
        envs["RANK"] = *id;
        envs["LOCAL_RANK"] = Json("0");
      }
      if (const Json* coord = either(kAnnCoordinator, kJobAnnCoordinator)) {
        // "host:port", split at the last colon
        const std::string& addr = coord->as_string();
        size_t colon = addr.rfind(':');
        envs["MASTER_ADDR"] = Json(colon == std::string::npos ? "" : addr.substr(0, colon));
        envs["MASTER_PORT"] =
            Json(colon == std::string::npos ? addr : addr.substr(colon + 1));
      }
      if (const Json* names = either(kAnnWorkerHostnames, kJobAnnWorkerHostnames)) {
        int64_t hosts = 0;
        for (const auto& h : ktpu::split(names->as_string(), ',')) hosts += !h.empty();
        envs["WORLD_SIZE"] = Json(std::to_string(hosts));
      }
    }
    JsonObject annotations;
    annotations["gpu.ktpu.io/injected"] = Json("true");
    annotations["gpu.ktpu.io/plugin"] = Json("native");
    JsonObject spec;
    spec["envs"] = Json(envs);
    spec["mounts"] = Json(JsonArray{});
    spec["devices"] = Json(dev_specs);
    spec["annotations"] = Json(annotations);
    return Json(spec);
  }

 private:
  const Device* find(const std::string& id) const {
    for (const auto& d : devices_)
      if (d.card.id == id) return &d;
    return nullptr;
  }

  std::mutex mu_;
  std::vector<Device> devices_;
};

bool write_line(int fd, const std::string& payload) {
  std::string line = payload + "\n";
  size_t off = 0;
  while (off < line.size()) {
    ssize_t n = write(fd, line.data() + off, line.size() - off);
    if (n <= 0) return false;
    off += static_cast<size_t>(n);
  }
  return true;
}

// ListAndWatch: the inventory at once, then a health pass every
// kHealthCheckSeconds, pushing the inventory again when a card flips.
void serve_stream(int fd, GPUPlugin& plugin, int64_t rid) {
  auto send = [&](const Json& devices) {
    JsonObject result;
    result["devices"] = devices;
    JsonObject frame;
    frame["stream"] = Json(rid);
    frame["result"] = Json(result);
    return write_line(fd, Json(frame).dump());
  };
  if (!send(plugin.list_devices())) return;
  while (true) {
    sleep(kHealthCheckSeconds);
    if (plugin.check_health() && !send(plugin.list_devices())) return;
  }
}

void serve_conn(int fd, GPUPlugin& plugin) {
  std::string buf;
  char chunk[4096];
  while (true) {
    size_t nl;
    while ((nl = buf.find('\n')) == std::string::npos) {
      ssize_t n = read(fd, chunk, sizeof chunk);
      if (n <= 0) {
        close(fd);
        return;
      }
      buf.append(chunk, static_cast<size_t>(n));
    }
    std::string line = buf.substr(0, nl);
    buf.erase(0, nl + 1);
    Json req;
    try {
      req = Json::parse(line);
    } catch (const std::exception&) {
      break;
    }
    std::string method = req.get("method");
    int64_t rid = req["id"].as_int();
    if (method == "ListAndWatch") {
      serve_stream(fd, plugin, rid);
      break;
    }
    JsonObject resp;
    resp["id"] = Json(rid);
    try {
      if (method == "GetPluginInfo") resp["result"] = plugin.get_plugin_info();
      else if (method == "AdmitPod") resp["result"] = plugin.admit_pod(req["params"]);
      else if (method == "InitContainer") resp["result"] = plugin.init_container(req["params"]);
      else resp["error"] = Json("unknown method '" + method + "'");
    } catch (const std::exception& e) {
      resp["error"] = Json(e.what());
    }
    if (!write_line(fd, Json(resp).dump())) break;
  }
  close(fd);
}

void make_dirs(const std::string& path) {
  std::string cur;
  for (const auto& part : ktpu::split(path, '/')) {
    if (part.empty()) {
      if (cur.empty()) cur = "/";
      continue;
    }
    cur += (cur.empty() || cur.back() == '/') ? part : "/" + part;
    mkdir(cur.c_str(), 0755);
  }
}

}  // namespace

int main(int argc, char** argv) {
  std::string plugin_dir =
      ktpu::getenv_or("KTPU_PLUGIN_DIR", "/var/lib/ktpu/device-plugins");
  for (int i = 1; i + 1 < argc; i += 2)
    if (strcmp(argv[i], "--plugin-dir") == 0) plugin_dir = argv[i + 1];

  std::vector<Card> cards;
  {
    ktpu::nvml::Library nvml;  // real mode: one pass, then shut down
    std::string why;
    if (!ktpu::discover(nvml, &cards, &why)) {
      fprintf(stderr,
              "ktpu-gpu-plugin: real mode needs NVML: %s (KTPU_FAKE_GPUS selects fake mode)\n",
              why.c_str());
      return 1;
    }
  }

  // Every thread inherits this mask: the signals reach only sigwait below.
  signal(SIGPIPE, SIG_IGN);
  sigset_t stop_signals;
  sigemptyset(&stop_signals);
  sigaddset(&stop_signals, SIGTERM);
  sigaddset(&stop_signals, SIGINT);
  pthread_sigmask(SIG_BLOCK, &stop_signals, nullptr);

  std::string sock_dir = plugin_dir + "/nvidia.com";
  make_dirs(sock_dir);
  std::string sock_path = sock_dir + "/gpu.sock";
  struct sockaddr_un addr;
  memset(&addr, 0, sizeof addr);
  addr.sun_family = AF_UNIX;
  if (sock_path.size() >= sizeof addr.sun_path) {
    fprintf(stderr, "ktpu-gpu-plugin: socket path too long: %s\n", sock_path.c_str());
    return 1;
  }
  strncpy(addr.sun_path, sock_path.c_str(), sizeof addr.sun_path - 1);
  unlink(sock_path.c_str());
  int srv = socket(AF_UNIX, SOCK_STREAM, 0);
  if (srv < 0) {
    perror("socket");
    return 1;
  }
  if (bind(srv, reinterpret_cast<struct sockaddr*>(&addr), sizeof addr) != 0) {
    perror("bind");
    return 1;
  }
  if (listen(srv, 16) != 0) {
    perror("listen");
    return 1;
  }

  auto* plugin = new GPUPlugin(cards);  // lives until the process exits
  printf("ktpu-gpu-plugin (native): advertising %zu card(s) at %s\n", plugin->device_count(),
         sock_path.c_str());
  fflush(stdout);

  std::thread([srv, plugin] {
    while (true) {
      int fd = accept(srv, nullptr, nullptr);
      if (fd < 0) {
        if (errno == EINTR || errno == ECONNABORTED) continue;
        return;
      }
      std::thread([fd, plugin] { serve_conn(fd, *plugin); }).detach();
    }
  }).detach();

  int sig = 0;
  sigwait(&stop_signals, &sig);
  close(srv);
  unlink(sock_path.c_str());
  fprintf(stderr, "ktpu-gpu-plugin: signal %d, socket %s removed\n", sig, sock_path.c_str());
  _exit(0);
}
