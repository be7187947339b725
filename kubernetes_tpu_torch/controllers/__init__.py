"""Controllers of the PyTorch port: the reconcile base (``base.py``) and the
ResourceClaim controller, which DRA claim templates need. The controller
manager and the other controllers are ROADMAP Queue A item 14."""

from kubernetes_tpu_torch.controllers.base import Controller
from kubernetes_tpu_torch.controllers.resourceclaim import (
    ResourceClaimController)

__all__ = ["Controller", "ResourceClaimController"]
