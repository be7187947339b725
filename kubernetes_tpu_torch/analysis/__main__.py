"""``python -m kubernetes_tpu_torch.analysis`` — standalone ktpu-lint."""

import sys

from kubernetes_tpu_torch.analysis.cli import main

if __name__ == "__main__":
    sys.exit(main())
