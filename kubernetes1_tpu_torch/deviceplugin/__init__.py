"""The ``nvidia.com/gpu`` device plane: the plugin protocol and the GPU plugin."""

from .api import (
    ContainerSpec,
    DeviceSpec,
    Mount,
    PluginClient,
    PluginServer,
    plugin_socket_path,
)
from .gpu_plugin import GPUDevicePlugin, discover_gpu_devices
