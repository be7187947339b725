"""CLI — ktpu, the kubectl analog, on the port (cli/ktpu.py)."""

from kubernetes_tpu_torch.cli.ktpu import main

__all__ = ["main"]
