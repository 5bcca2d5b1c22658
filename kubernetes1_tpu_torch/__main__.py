"""The port's component processes behind one entry point:

    python -m kubernetes1_tpu_torch apiserver --port N [--host H] [--wal F]
        [--authorization-mode Node,RBAC --tls-cert-file ... (the security flags)]
    python -m kubernetes1_tpu_torch scheduler --server URL [--metrics-port -1]
    python -m kubernetes1_tpu_torch controller-manager --server URL [--metrics-port -1]
    python -m kubernetes1_tpu_torch kubelet --server URL --node-name N [--runtime process|fake]
        [--plugin-dir D] [--root-dir R] [--tls-cert-file C --tls-key-file K]
    python -m kubernetes1_tpu_torch ktpu [--server URL] <command> ...   (or: cli)
    python -m kubernetes1_tpu_torch ktpu init --dir D   (then ktpu join on other hosts)

(the JAX package's ``python -m kubernetes1_tpu <component>``, for the
components the port has; ``ktpu`` is the CLI, ``python -m
kubernetes1_tpu_torch.cli``).  Every component that takes ``--server``
takes ``--kubeconfig``, ``--token``, ``--ca-file``, ``--client-cert-file``
and ``--client-key-file`` too.
"""

from __future__ import annotations

import importlib
import sys

COMPONENTS = {
    "apiserver": "kubernetes1_tpu_torch.apiserver.__main__",
    "scheduler": "kubernetes1_tpu_torch.scheduler.__main__",
    "controller-manager": "kubernetes1_tpu_torch.controllers.__main__",
    "kubelet": "kubernetes1_tpu_torch.kubelet.__main__",
    "ktpu": "kubernetes1_tpu_torch.cli",
    "cli": "kubernetes1_tpu_torch.cli",
}


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    names = ", ".join(sorted(COMPONENTS))
    if not argv or argv[0] in ("-h", "--help"):
        print(f"usage: python -m kubernetes1_tpu_torch <component> [args...]\n"
              f"components: {names}")
        return 0 if argv else 2
    name, rest = argv[0], argv[1:]
    if name not in COMPONENTS:
        print(f"error: unknown component {name!r} (have {names})", file=sys.stderr)
        return 2
    mod = importlib.import_module(COMPONENTS[name])
    sys.argv = [f"ktpu-{name}"] + rest
    result = mod.main()
    return 0 if result is None else result


if __name__ == "__main__":
    sys.exit(main())
