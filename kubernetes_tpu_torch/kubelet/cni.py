"""CNI — the exec-based network plugin seam.

Reference: the CNI spec as the container runtime invokes it for the
kubelet (``RunPodSandbox`` -> network namespace -> CNI ADD): the plugin is
an EXECUTABLE, the network config arrives on stdin as JSON, the verb and
identifiers ride environment variables (CNI_COMMAND=ADD|DEL,
CNI_CONTAINERID, CNI_NETNS, CNI_IFNAME), and the result — IP assignments —
returns on stdout as JSON. This module is the runtime side of that seam
plus a bundled host-local IPAM plugin (the reference plugins' most common
IPAM) written as a self-contained script, so tests exercise a REAL process
boundary: allocation state lives in the plugin's data dir, not in this
interpreter.
"""

from __future__ import annotations

import json
import os
import stat
import subprocess
import tempfile
from typing import Optional

HOST_LOCAL_PLUGIN = """#!/usr/bin/env python3
# host-local IPAM (containernetworking/plugins/plugins/ipam/host-local
# analog): sequential allocation from conf["subnet"], state on disk.
import fcntl, json, os, sys

conf = json.load(sys.stdin)
cmd = os.environ.get("CNI_COMMAND", "")
cid = os.environ.get("CNI_CONTAINERID", "")
data = conf.get("dataDir") or "/tmp/cni-host-local"
os.makedirs(data, exist_ok=True)
subnet = conf.get("subnet", "10.88.0.0/16")
base = subnet.split("/")[0].rsplit(".", 2)[0]  # /16 assumed: a.b
state = os.path.join(data, "state.json")

with open(os.path.join(data, "lock"), "w") as lk:
    fcntl.flock(lk, fcntl.LOCK_EX)
    try:
        alloc = json.load(open(state))
    except Exception:
        alloc = {"next": 2, "ips": {}}
    if cmd == "ADD":
        if cid in alloc["ips"]:
            ip = alloc["ips"][cid]
        else:
            n = alloc["next"]
            alloc["next"] = n + 1
            ip = f"{base}.{(n >> 8) & 0xff}.{n & 0xff}"
            alloc["ips"][cid] = ip
        json.dump(alloc, open(state, "w"))
        json.dump({"cniVersion": "1.0.0",
                   "ips": [{"address": ip + "/16"}]}, sys.stdout)
    elif cmd == "DEL":
        alloc["ips"].pop(cid, None)
        json.dump(alloc, open(state, "w"))
        sys.stdout.write("{}")
    else:
        sys.stderr.write(f"unknown CNI_COMMAND {cmd!r}")
        sys.exit(1)
"""


def install_host_local_plugin(bin_dir: str) -> str:
    """Write the bundled host-local plugin executable into ``bin_dir``."""
    path = os.path.join(bin_dir, "host-local")
    with open(path, "w") as f:
        f.write(HOST_LOCAL_PLUGIN)
    os.chmod(path, os.stat(path).st_mode | stat.S_IXUSR | stat.S_IXGRP)
    return path


class CNI:
    """Invoke a CNI plugin executable per sandbox (ADD on create, DEL on
    teardown) and parse the IP result — what the runtime does between
    RunPodSandbox and the sandbox becoming routable."""

    def __init__(self, plugin_path: Optional[str] = None,
                 netconf: Optional[dict] = None,
                 data_dir: Optional[str] = None):
        if plugin_path is None:
            self._tmp = tempfile.mkdtemp(prefix="cni-bin-")
            plugin_path = install_host_local_plugin(self._tmp)
        self.plugin_path = plugin_path
        self.data_dir = data_dir or tempfile.mkdtemp(prefix="cni-data-")
        self.netconf = dict(netconf or {"cniVersion": "1.0.0",
                                        "name": "ktpu-net",
                                        "type": "host-local",
                                        "subnet": "10.88.0.0/16"})
        self.netconf.setdefault("dataDir", self.data_dir)

    def _exec(self, command: str, container_id: str) -> dict:
        env = {**os.environ,
               "CNI_COMMAND": command,
               "CNI_CONTAINERID": container_id,
               "CNI_NETNS": f"/var/run/netns/{container_id}",
               "CNI_IFNAME": "eth0",
               "CNI_PATH": os.path.dirname(self.plugin_path)}
        proc = subprocess.run(
            [self.plugin_path], input=json.dumps(self.netconf),
            capture_output=True, text=True, env=env, timeout=10.0)
        if proc.returncode != 0:
            raise RuntimeError(
                f"CNI {command} failed rc={proc.returncode}: "
                f"{proc.stderr.strip()[:500]}")
        return json.loads(proc.stdout or "{}")

    def add(self, container_id: str) -> str:
        """-> the sandbox IP (first assignment, address without prefix)."""
        out = self._exec("ADD", container_id)
        ips = out.get("ips") or []
        if not ips:
            raise RuntimeError("CNI ADD returned no IPs")
        return ips[0]["address"].split("/")[0]

    def delete(self, container_id: str) -> None:
        self._exec("DEL", container_id)

    def ip_allocator(self):
        """An ``ip_alloc`` callable for FakeRuntime: each sandbox creation
        execs the plugin (ADD keyed by a fresh id)."""
        import itertools
        seq = itertools.count()
        return lambda: self.add(f"sandbox-{next(seq)}")
