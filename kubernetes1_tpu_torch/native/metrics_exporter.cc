// ktpu-gpu-metrics-exporter: the native GPU metrics exporter.
//
// The DCGM-style exporter of a GPU node, the counterpart of the TPU
// exporter: Prometheus text about the node's cards, scraped from a
// DaemonSet on every GPU node.  Discovery is the plugin's (gpus.hpp), so
// both binaries name a card the same way.
//
//   every mode:     ktpu_gpu_cards{host}, ktpu_gpu_card_healthy{host,card,
//                   uuid,model} (its /dev/nvidia<minor> node is there) and
//                   ktpu_gpu_cards_healthy{host};
//   real mode only: a line a card, read from NVML at each scrape:
//                   ktpu_gpu_utilization_ratio (0-1),
//                   ktpu_gpu_memory_used_bytes, ktpu_gpu_memory_total_bytes,
//                   ktpu_gpu_power_watts, ktpu_gpu_power_limit_watts and
//                   ktpu_gpu_temperature_celsius.
//
// Fake mode (KTPU_FAKE_GPUS) prints no reading at all.  In real mode it
// exits non-zero when NVML cannot be used.
//
// GET /metrics  -> Prometheus text exposition
// GET /healthz  -> ok
//
//   ktpu-gpu-metrics-exporter [--port P]   (default $KTPU_EXPORTER_PORT or
//                                           9101; 0 picks a free port and
//                                           prints it)
//
// Build: make -C kubernetes1_tpu_torch/native

#include <arpa/inet.h>
#include <netinet/in.h>
#include <signal.h>
#include <stdio.h>
#include <string.h>
#include <sys/socket.h>
#include <unistd.h>

#include <sstream>
#include <string>
#include <thread>
#include <vector>

#include "gpus.hpp"

using ktpu::Card;

namespace {

struct Exporter {
  ktpu::nvml::Library nvml;  // opened in real mode only
  std::vector<Card> cards;
  std::string host = ktpu::host_name();
  bool real = false;
};

std::string card_labels(const Exporter& ex, const Card& c) {
  return "host=\"" + ex.host + "\",card=\"" + c.id + "\",uuid=\"" + c.uuid + "\"";
}

// One reading a card for each metric whose NVML call succeeds.
void render_readings(Exporter& ex, std::ostringstream& out) {
  struct Reading {
    const char* name;
    const char* help;
    std::vector<std::string> lines;
  };
  Reading util{"ktpu_gpu_utilization_ratio",
               "Share of the last sample period in which a kernel ran on the card", {}};
  Reading used{"ktpu_gpu_memory_used_bytes", "Device memory in use", {}};
  Reading total{"ktpu_gpu_memory_total_bytes", "Device memory of the card", {}};
  Reading power{"ktpu_gpu_power_watts", "Power draw of the card", {}};
  Reading limit{"ktpu_gpu_power_limit_watts", "Enforced power limit of the card", {}};
  Reading temp{"ktpu_gpu_temperature_celsius", "Temperature of the GPU die", {}};
  auto& lib = ex.nvml;
  for (const auto& c : ex.cards) {
    std::string labels = "{" + card_labels(ex, c) + "} ";
    ktpu::nvml::nvmlUtilization_t u{};
    if (lib.DeviceGetUtilizationRates(c.handle, &u) == ktpu::nvml::kSuccess)
      util.lines.push_back(labels + std::to_string(u.gpu / 100.0));
    ktpu::nvml::nvmlMemory_t m{};
    if (lib.DeviceGetMemoryInfo(c.handle, &m) == ktpu::nvml::kSuccess) {
      used.lines.push_back(labels + std::to_string(m.used));
      total.lines.push_back(labels + std::to_string(m.total));
    }
    unsigned int v = 0;
    if (lib.DeviceGetPowerUsage(c.handle, &v) == ktpu::nvml::kSuccess)
      power.lines.push_back(labels + std::to_string(v / 1000.0));
    if (lib.DeviceGetEnforcedPowerLimit(c.handle, &v) == ktpu::nvml::kSuccess)
      limit.lines.push_back(labels + std::to_string(v / 1000.0));
    if (lib.DeviceGetTemperature(c.handle, ktpu::nvml::kTemperatureGpu, &v) ==
        ktpu::nvml::kSuccess)
      temp.lines.push_back(labels + std::to_string(v));
  }
  for (const Reading* r : {&util, &used, &total, &power, &limit, &temp}) {
    out << "# HELP " << r->name << " " << r->help << "\n# TYPE " << r->name << " gauge\n";
    for (const auto& line : r->lines) out << r->name << line << "\n";
  }
}

std::string render_metrics(Exporter& ex) {
  std::ostringstream out;
  out << "# HELP ktpu_gpu_cards GPUs discovered on this host\n"
      << "# TYPE ktpu_gpu_cards gauge\n"
      << "ktpu_gpu_cards{host=\"" << ex.host << "\"} " << ex.cards.size() << "\n"
      << "# HELP ktpu_gpu_card_healthy Per-card health (1 healthy, 0 unhealthy)\n"
      << "# TYPE ktpu_gpu_card_healthy gauge\n";
  size_t healthy = 0;
  for (const auto& c : ex.cards) {
    bool ok = c.path.empty() || ktpu::node_exists(c.path);
    healthy += ok;
    out << "ktpu_gpu_card_healthy{" << card_labels(ex, c) << ",model=\"" << c.model << "\"} "
        << (ok ? 1 : 0) << "\n";
  }
  out << "# HELP ktpu_gpu_cards_healthy Healthy GPUs on this host\n"
      << "# TYPE ktpu_gpu_cards_healthy gauge\n"
      << "ktpu_gpu_cards_healthy{host=\"" << ex.host << "\"} " << healthy << "\n";
  if (ex.real) render_readings(ex, out);
  return out.str();
}

void serve_conn(int fd, Exporter& ex) {
  char buf[4096];
  ssize_t n = read(fd, buf, sizeof buf - 1);
  if (n <= 0) {
    close(fd);
    return;
  }
  buf[n] = 0;
  std::string req(buf);
  std::string body, status = "200 OK";
  if (req.rfind("GET /metrics", 0) == 0) {
    body = render_metrics(ex);
  } else if (req.rfind("GET /healthz", 0) == 0) {
    body = "ok\n";
  } else {
    status = "404 Not Found";
    body = "not found\n";
  }
  std::ostringstream resp;
  resp << "HTTP/1.1 " << status << "\r\nContent-Type: text/plain; version=0.0.4"
       << "\r\nContent-Length: " << body.size() << "\r\nConnection: close\r\n\r\n"
       << body;
  std::string payload = resp.str();
  size_t off = 0;
  while (off < payload.size()) {
    ssize_t w = write(fd, payload.data() + off, payload.size() - off);
    if (w <= 0) break;
    off += static_cast<size_t>(w);
  }
  close(fd);
}

}  // namespace

int main(int argc, char** argv) {
  int port = atoi(ktpu::getenv_or("KTPU_EXPORTER_PORT", "9101").c_str());
  for (int i = 1; i + 1 < argc; i += 2)
    if (strcmp(argv[i], "--port") == 0) port = atoi(argv[i + 1]);
  signal(SIGPIPE, SIG_IGN);

  auto* ex = new Exporter;  // lives until the process exits
  ex->real = ktpu::getenv_or("KTPU_FAKE_GPUS", "").empty();
  std::string why;
  if (!ktpu::discover(ex->nvml, &ex->cards, &why)) {
    fprintf(stderr,
            "ktpu-gpu-metrics-exporter: real mode needs NVML: %s "
            "(KTPU_FAKE_GPUS selects fake mode)\n",
            why.c_str());
    return 1;
  }

  int srv = socket(AF_INET, SOCK_STREAM, 0);
  int one = 1;
  setsockopt(srv, SOL_SOCKET, SO_REUSEADDR, &one, sizeof one);
  struct sockaddr_in addr;
  memset(&addr, 0, sizeof addr);
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (bind(srv, reinterpret_cast<struct sockaddr*>(&addr), sizeof addr) != 0) {
    perror("bind");
    return 1;
  }
  if (listen(srv, 16) != 0) {
    perror("listen");
    return 1;
  }
  if (port == 0) {
    socklen_t len = sizeof addr;
    getsockname(srv, reinterpret_cast<struct sockaddr*>(&addr), &len);
    port = ntohs(addr.sin_port);
  }
  printf("ktpu-gpu-metrics-exporter (native): %zu card(s), listening on 127.0.0.1:%d\n",
         ex->cards.size(), port);
  fflush(stdout);

  while (true) {
    int fd = accept(srv, nullptr, nullptr);
    if (fd < 0) continue;
    std::thread([fd, ex] { serve_conn(fd, *ex); }).detach();
  }
}
