// The few NVML declarations the native GPU plugin and exporter use,
// declared by hand and resolved at run time from the NVIDIA display
// driver's libnvidia-ml.so.1 (dlopen + dlsym), so both binaries build with a plain
// g++ and no CUDA headers.  NVML is present wherever nvidia-smi works and
// never creates a CUDA context: a context in a node daemon would hold card
// memory that the pod needs.
#pragma once

#include <dlfcn.h>

#include <string>

namespace ktpu {
namespace nvml {

typedef struct nvmlDevice_st* nvmlDevice_t;  // opaque
typedef int nvmlReturn_t;                    // NVML_SUCCESS is 0

struct nvmlMemory_t {
  unsigned long long total;
  unsigned long long free;
  unsigned long long used;
};

struct nvmlUtilization_t {
  unsigned int gpu;     // percent of the last sample period a kernel ran
  unsigned int memory;  // percent of it that device memory was read or written
};

constexpr nvmlReturn_t kSuccess = 0;
constexpr int kP2PCapsIndexNvlink = 2;  // NVML_P2P_CAPS_INDEX_NVLINK
constexpr int kP2PStatusOk = 0;         // NVML_P2P_STATUS_OK
constexpr int kTemperatureGpu = 0;        // NVML_TEMPERATURE_GPU
constexpr unsigned int kStringBuffer = 96;  // NVML_DEVICE_{UUID,NAME}_V2_BUFFER_SIZE

// libnvidia-ml.so.1, opened and initialised; shut down and closed with
// the object.  ``open`` says why it could not be used.
class Library {
 public:
  nvmlReturn_t (*Init)() = nullptr;
  nvmlReturn_t (*Shutdown)() = nullptr;
  nvmlReturn_t (*DeviceGetCount)(unsigned int*) = nullptr;
  nvmlReturn_t (*DeviceGetHandleByIndex)(unsigned int, nvmlDevice_t*) = nullptr;
  nvmlReturn_t (*DeviceGetUUID)(nvmlDevice_t, char*, unsigned int) = nullptr;
  nvmlReturn_t (*DeviceGetName)(nvmlDevice_t, char*, unsigned int) = nullptr;
  nvmlReturn_t (*DeviceGetMinorNumber)(nvmlDevice_t, unsigned int*) = nullptr;
  // v1: its total is nvidia-smi's fb_memory_usage total (the _v2 call
  // counts the memory the NVIDIA driver reserves too)
  nvmlReturn_t (*DeviceGetMemoryInfo)(nvmlDevice_t, nvmlMemory_t*) = nullptr;
  nvmlReturn_t (*DeviceGetUtilizationRates)(nvmlDevice_t, nvmlUtilization_t*) = nullptr;
  nvmlReturn_t (*DeviceGetPowerUsage)(nvmlDevice_t, unsigned int*) = nullptr;  // mW
  nvmlReturn_t (*DeviceGetEnforcedPowerLimit)(nvmlDevice_t, unsigned int*) = nullptr;  // mW
  nvmlReturn_t (*DeviceGetTemperature)(nvmlDevice_t, int, unsigned int*) = nullptr;  // C
  // whether two cards reach each other over NVLink (caps index
  // kP2PCapsIndexNvlink, status kP2PStatusOk); optional: null when the
  // library lacks it, and then every card is an NVLink domain of its own
  nvmlReturn_t (*DeviceGetP2PStatus)(nvmlDevice_t, nvmlDevice_t, int, int*) = nullptr;

  Library() = default;
  Library(const Library&) = delete;
  Library& operator=(const Library&) = delete;

  ~Library() {
    if (initialised_) Shutdown();
    if (handle_ != nullptr) dlclose(handle_);
  }

  bool open(std::string* why) {
    handle_ = dlopen("libnvidia-ml.so.1", RTLD_NOW | RTLD_LOCAL);
    if (handle_ == nullptr) {
      const char* err = dlerror();
      *why = std::string("cannot load libnvidia-ml.so.1: ") + (err ? err : "unknown error");
      return false;
    }
    bool ok = resolve(&Init, "nvmlInit_v2", why) && resolve(&Shutdown, "nvmlShutdown", why) &&
              resolve(&DeviceGetCount, "nvmlDeviceGetCount_v2", why) &&
              resolve(&DeviceGetHandleByIndex, "nvmlDeviceGetHandleByIndex_v2", why) &&
              resolve(&DeviceGetUUID, "nvmlDeviceGetUUID", why) &&
              resolve(&DeviceGetName, "nvmlDeviceGetName", why) &&
              resolve(&DeviceGetMinorNumber, "nvmlDeviceGetMinorNumber", why) &&
              resolve(&DeviceGetMemoryInfo, "nvmlDeviceGetMemoryInfo", why) &&
              resolve(&DeviceGetUtilizationRates, "nvmlDeviceGetUtilizationRates", why) &&
              resolve(&DeviceGetPowerUsage, "nvmlDeviceGetPowerUsage", why) &&
              resolve(&DeviceGetEnforcedPowerLimit, "nvmlDeviceGetEnforcedPowerLimit", why) &&
              resolve(&DeviceGetTemperature, "nvmlDeviceGetTemperature", why);
    if (!ok) return false;
    DeviceGetP2PStatus =
        reinterpret_cast<decltype(DeviceGetP2PStatus)>(dlsym(handle_, "nvmlDeviceGetP2PStatus"));
    nvmlReturn_t rc = Init();
    if (rc != kSuccess) {
      *why = "nvmlInit_v2 failed with NVML error " + std::to_string(rc);
      return false;
    }
    initialised_ = true;
    return true;
  }

 private:
  template <typename Fn>
  bool resolve(Fn* fn, const char* name, std::string* why) {
    *fn = reinterpret_cast<Fn>(dlsym(handle_, name));
    if (*fn == nullptr) {
      *why = std::string("libnvidia-ml.so.1 lacks ") + name;
      return false;
    }
    return true;
  }

  void* handle_ = nullptr;
  bool initialised_ = false;
};

}  // namespace nvml
}  // namespace ktpu
