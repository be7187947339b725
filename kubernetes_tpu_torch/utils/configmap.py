"""Create-or-update for published status ConfigMaps.

Several components publish their live state as a ConfigMap an operator
reads through ``ktpu status`` (scheduler status/trace/explanations, the
hollow fleet, the node-lifecycle disruption mode). Each had grown its own
get/update-else-create with subtly different error handling — this is the
one shared upsert: best-effort (publishing must never take a component
down), but a lost race retries once instead of silently dropping an
on-change publish, and failures are counted + logged, never swallowed
bare."""

from __future__ import annotations

import logging

from kubernetes_tpu_torch.client.clientset import ApiError
from kubernetes_tpu_torch.metrics.registry import LOOP_ERRORS

_LOG = logging.getLogger("kubernetes_tpu_torch.utils.configmap")


def upsert_configmap(client, namespace: str, name: str, data: dict,
                     site: str = "publish_status") -> bool:
    """Write ``data`` into ConfigMap ``namespace/name`` (create it if
    absent). -> True when the write landed. One retry absorbs the two
    benign races (update hits a concurrent writer's 409; create hits a
    concurrent creator's 409/AlreadyExists); anything else is counted
    under ``scheduler_loop_errors_total{site=...}`` and logged."""
    body = {"apiVersion": "v1", "kind": "ConfigMap",
            "metadata": {"name": name, "namespace": namespace},
            "data": data}
    cms = client.resource("configmaps", namespace)
    for attempt in (0, 1):
        try:
            try:
                current = cms.get(name)
                current["data"] = data
                cms.update(current)
            except ApiError as e:
                if e.code != 404:
                    raise
                cms.create(body)
            return True
        except ApiError as e:
            if e.code == 409 and attempt == 0:
                continue  # racing writer/creator: re-read and retry once
            LOOP_ERRORS.inc({"site": site})
            _LOG.debug("%s ConfigMap publish failed: %s", name, e)
            return False
        except Exception:
            LOOP_ERRORS.inc({"site": site})
            _LOG.debug("%s ConfigMap publish failed", name, exc_info=True)
            return False
    return False
