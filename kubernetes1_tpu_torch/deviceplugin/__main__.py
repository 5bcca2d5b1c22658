"""``python -m kubernetes1_tpu_torch.deviceplugin --plugin-dir D``: run the
GPU device plugin until SIGTERM or SIGINT."""

from .gpu_plugin import main

main()
