"""Volume manager — desired-state vs actual-state mount reconcile.

Reference: ``pkg/kubelet/volumemanager/`` (``volume_manager.go``:
DesiredStateOfWorld populated from admitted pods' volumes, the reconciler
loop mounting what's desired-but-unmounted and unmounting what's
mounted-but-undesired; ``WaitForAttachAndMount`` gating container start).

The hollow "mount" records the volume in the actual-state map (optionally
resolving a PVC to its bound PV name like the operation executor does); the
load-bearing parts are the reconcile algebra and the start gate, which are
real.
"""

from __future__ import annotations

import threading
import time
from typing import Optional


def pod_volume_names(pod: dict) -> list[str]:
    """Unique volume identifiers for a pod: pvc:<claim> for PVC-backed
    volumes (node-level identity — two pods sharing a claim share the
    mount), csi:<volumeHandle> for inline CSI volumes, else <uid>/<name>
    for pod-local volumes."""
    uid = (pod.get("metadata") or {}).get("uid", "")
    out = []
    for v in (pod.get("spec") or {}).get("volumes") or []:
        pvc = (v.get("persistentVolumeClaim") or {}).get("claimName")
        csi = (v.get("csi") or {}).get("volumeHandle") \
            or ((v.get("csi") or {}).get("volumeAttributes")
                or {}).get("handle")
        if pvc:
            out.append(f"pvc:{pvc}")
        elif csi:
            out.append(f"csi:{csi}")
        else:
            out.append(f"{uid}/{v.get('name', '')}")
    return out


class VolumeManager:
    def __init__(self, reconcile_s: float = 0.1, csi_plugin=None):
        """``csi_plugin``: a kubelet/csi.py CSIVolumePlugin — csi:<handle>
        volumes are staged/published across the gRPC driver boundary
        instead of the hollow mount (pkg/volume/csi's operation executor
        hop)."""
        self.reconcile_s = reconcile_s
        self.csi = csi_plugin
        self._lock = threading.Lock()
        self._desired: dict[str, set] = {}   # volume id -> {pod uids}
        self._mounted: set = set()           # volume ids actually mounted
        self._csi_published: dict[str, set] = {}  # vol -> {pod uids}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.mount_ops: list[tuple[str, str]] = []  # ("mount"/"unmount", vol)

    # ---- desired state (pod admission/removal) ---------------------------

    def add_pod(self, pod: dict) -> None:
        uid = (pod.get("metadata") or {}).get("uid", "")
        with self._lock:
            for vol in pod_volume_names(pod):
                self._desired.setdefault(vol, set()).add(uid)

    def remove_pod(self, pod: dict) -> None:
        uid = (pod.get("metadata") or {}).get("uid", "")
        with self._lock:
            for vol in list(self._desired):
                self._desired[vol].discard(uid)
                if not self._desired[vol]:
                    del self._desired[vol]

    # ---- reconcile -------------------------------------------------------

    def reconcile_once(self) -> None:
        csi_ops: list[tuple] = []
        with self._lock:
            want = set(self._desired)
            to_mount = want - self._mounted
            to_unmount = self._mounted - want
            for vol in sorted(to_mount):
                if self.csi is not None and vol.startswith("csi:"):
                    # publish for EVERY pod that wants it (per-pod target
                    # paths), mount recorded only after the driver succeeds
                    for uid in sorted(self._desired[vol]):
                        csi_ops.append(("mount", vol, uid, False))
                    continue
                self._mounted.add(vol)
                self.mount_ops.append(("mount", vol))
            # csi volumes stay mounted only while publishes succeed; also
            # publish for pods that joined an already-mounted csi volume
            if self.csi is not None:
                for vol in sorted(want & self._mounted):
                    if not vol.startswith("csi:"):
                        continue
                    for uid in sorted(self._desired[vol]
                                      - self._csi_published.get(vol, set())):
                        csi_ops.append(("mount", vol, uid, False))
                for vol in sorted(self._mounted):
                    if vol.startswith("csi:"):
                        gone = sorted(self._csi_published.get(vol, set())
                                      - self._desired.get(vol, set()))
                        live = self._desired.get(vol, set())
                        for i, uid in enumerate(gone):
                            # only the FINAL unpublish may unstage — the
                            # CSI ordering forbids unstaging while any pod
                            # is still published
                            last = not live and i == len(gone) - 1
                            csi_ops.append(("unmount", vol, uid, last))
            for vol in sorted(to_unmount):
                if self.csi is not None and vol.startswith("csi:"):
                    continue  # handled via per-pod unpublish above
                self._mounted.discard(vol)
                self.mount_ops.append(("unmount", vol))
        # drive the CSI driver OUTSIDE the lock (gRPC round trips)
        for op, vol, uid, last in csi_ops:
            handle = vol.split(":", 1)[1]
            try:
                if op == "mount":
                    self.csi.mount(handle, uid)
                    with self._lock:
                        self._csi_published.setdefault(vol, set()).add(uid)
                        self._mounted.add(vol)
                        self.mount_ops.append(("mount", f"{vol}/{uid}"))
                else:
                    self.csi.unmount(handle, uid, last_pod=last)
                    with self._lock:
                        pubs = self._csi_published.get(vol, set())
                        pubs.discard(uid)
                        self.mount_ops.append(("unmount", f"{vol}/{uid}"))
                        if not pubs:
                            self._csi_published.pop(vol, None)
                            self._mounted.discard(vol)
            except Exception:
                import logging
                logging.getLogger(__name__).exception(
                    "CSI %s of %s for pod %s failed (retried next "
                    "reconcile)", op, vol, uid)

    def _loop(self) -> None:
        while not self._stop.wait(self.reconcile_s):
            self.reconcile_once()

    def start(self) -> "VolumeManager":
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="volume-manager")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    # ---- the start gate --------------------------------------------------

    def wait_for_attach_and_mount(self, pod: dict, timeout: float = 5.0) -> bool:
        """Block until every volume the pod needs is mounted (the SyncPod
        gate before containers start). CSI volumes gate on THIS pod's
        publish — another pod's mount of a shared volume doesn't create
        this pod's target path."""
        uid = (pod.get("metadata") or {}).get("uid", "")
        want = set(pod_volume_names(pod))
        if not want:
            return True

        def ready_locked() -> bool:
            for vol in want:
                if self.csi is not None and vol.startswith("csi:"):
                    if uid not in self._csi_published.get(vol, set()):
                        return False
                elif vol not in self._mounted:
                    return False
            return True

        deadline = time.time() + timeout
        while time.time() < deadline:
            with self._lock:
                if ready_locked():
                    return True
            time.sleep(min(self.reconcile_s, 0.05))
        with self._lock:
            return ready_locked()

    def mounted_volumes(self) -> set:
        with self._lock:
            return set(self._mounted)
