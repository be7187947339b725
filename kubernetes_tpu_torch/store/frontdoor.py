"""The front door: a read-replica serving plane over the raft group.

One APIServer fronts EVERY raft node, not just the leader. Followers
serve GET/list/watch from their local (replicated) store — the watch
fan-out cost that otherwise concentrates on the leader spreads across
the group — while mutations on a follower answer 421 + an
``X-KTPU-Leader`` hint that the spread client chases. Reference role:
apiserver replicas in front of etcd, where any replica serves reads
from the watch cache and linearizable traffic goes through the leader.

Three pieces live here:

  FrontDoorCluster    in-process n-node group (RaftNode + APIServer per
                      node, ``api_urls`` cross-wired so NotLeader hints
                      are API urls, not raft peer urls). Tier-1 tests
                      and the WatchStorm bench's in-process legs use it.

  FrontDoorPublisher  leader-side loop that polls every replica's
                      ``GET /frontdoor/status`` and publishes the
                      aggregate into the ``kubernetes-tpu-frontdoor-
                      status`` ConfigMap — the feed ``ktpu status``
                      renders as its "Front door:" line.

  fetch_status /      the probe + aggregation helpers the publisher and
  aggregate_frontdoor the CLI share (plain dict in, str->str ConfigMap
                      data out; ``nodes`` is a JSON-encoded list).

``serve(conn, n)`` runs a FrontDoorCluster in a process of its own (the
raft group off the caller's interpreter).
"""

from __future__ import annotations

import json
import logging
import threading
import urllib.request
from typing import Optional

from kubernetes_tpu_torch.store.replication import RaftNode, ReplicatedStore
from kubernetes_tpu_torch.store.store import ObjectStore
from kubernetes_tpu_torch.utils.configmap import upsert_configmap

_LOG = logging.getLogger(__name__)

FRONTDOOR_CONFIGMAP = "kubernetes-tpu-frontdoor-status"
FRONTDOOR_NAMESPACE = "kube-system"


def fetch_status(api_url: str, timeout: float = 2.0) -> Optional[dict]:
    """One replica's ``GET /frontdoor/status`` -> dict, or None when the
    replica is unreachable (the aggregate renders it as down)."""
    try:
        with urllib.request.urlopen(api_url.rstrip("/")
                                    + "/frontdoor/status",
                                    timeout=timeout) as resp:
            return json.loads(resp.read())
    except Exception:  # ktpu-lint: disable=KTL002 -- liveness probe: any failure (refused, timeout, bad payload) = peer down, rendered as unreachable
        return None


def aggregate_frontdoor(statuses: "dict[str, Optional[dict]]") -> dict:
    """Per-endpoint status dicts -> the str->str ConfigMap ``data``
    payload. Scalar keys give ``ktpu status`` its one-line summary
    without parsing; ``nodes`` carries the full per-replica detail as a
    JSON list for ``-o json`` consumers."""
    nodes = []
    leader_url = ""
    replicas = 0
    watchers = drops = 0
    max_lag_ms = 0.0
    shards = 0
    for url in sorted(statuses):
        st = statuses[url]
        if st is None:
            nodes.append({"url": url, "reachable": False})
            continue
        watch = st.get("watch") or {}
        entry = {"url": url, "reachable": True,
                 "role": st.get("role", ""),
                 "node": st.get("node"),
                 "ready": bool(st.get("ready")),
                 "replayLagMs": st.get("replayLagMs"),
                 "watchers": int(watch.get("watchersTotal", 0)),
                 "drops": int(watch.get("dropsTotal", 0))}
        nodes.append(entry)
        if entry["role"] == "leader":
            leader_url = url
        else:
            replicas += 1
            if entry["replayLagMs"] is not None:
                max_lag_ms = max(max_lag_ms, float(entry["replayLagMs"]))
        watchers += entry["watchers"]
        drops += entry["drops"]
        shards = max(shards, int(watch.get("shardsPerKind", 0)))
    return {"leader": leader_url,
            "replicas": str(replicas),
            "watchersTotal": str(watchers),
            "dropsTotal": str(drops),
            "maxReplayLagMs": f"{max_lag_ms:.3f}",
            "shardsPerKind": str(shards),
            "nodes": json.dumps(nodes)}


class FrontDoorPublisher:
    """Publishes the aggregated front-door picture into the
    ``kubernetes-tpu-frontdoor-status`` ConfigMap every ``interval_s``.
    Runs wherever a writing client lives (the leader, or any spread
    client — writes chase the leader hint on their own). Publishing is
    best-effort: a failed probe or write must never take the plane down."""

    def __init__(self, client, endpoints, *,
                 namespace: str = FRONTDOOR_NAMESPACE,
                 interval_s: float = 5.0):
        self._client = client
        self.endpoints = [e.rstrip("/") for e in endpoints]
        self.namespace = namespace
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def publish_once(self) -> bool:
        statuses = {url: fetch_status(url) for url in self.endpoints}
        data = aggregate_frontdoor(statuses)
        return upsert_configmap(self._client, self.namespace,
                                FRONTDOOR_CONFIGMAP, data,
                                site="frontdoor_publish")

    def start(self) -> "FrontDoorPublisher":
        if self._thread is not None:
            return self
        self._thread = threading.Thread(target=self._loop,
                                        name="frontdoor-publisher",
                                        daemon=True)
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.publish_once()
            except Exception:
                # best-effort publisher: log and retry next tick
                _LOG.warning("frontdoor publish failed", exc_info=True)
            self._stop.wait(self.interval_s)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None


class FrontDoorCluster:
    """An in-process n-node front door: one RaftNode + one APIServer per
    node, ``api_urls`` cross-wired on every server so a follower's 421
    carries the LEADER'S API url (NotLeader.leader_hint is the raft peer
    url, which no API client can dial)."""

    def __init__(self, n: int = 3, host: str = "127.0.0.1",
                 data_dirs: Optional[list] = None,
                 max_replay_lag_s: float = 2.0,
                 commit_timeout: float = 15.0):
        if data_dirs is not None and len(data_dirs) != n:
            raise ValueError(f"need {n} data_dirs, got {len(data_dirs)}")
        self.n = n
        self.host = host
        self.data_dirs = data_dirs
        self.max_replay_lag_s = max_replay_lag_s
        self.commit_timeout = commit_timeout
        self.nodes: list[RaftNode] = []
        self.apis: list = []  # APIServer per node, same order as nodes

    # ---- lifecycle -------------------------------------------------------

    def start(self, leader_timeout: float = 30.0) -> "FrontDoorCluster":
        from kubernetes_tpu_torch.chaos.apiserver import free_port
        from kubernetes_tpu_torch.store.apiserver import APIServer
        raft_ports = [free_port(self.host) for _ in range(self.n)]
        for i in range(self.n):
            peers = {f"n{j}": f"http://{self.host}:{raft_ports[j]}"
                     for j in range(self.n) if j != i}
            store = ObjectStore(data_dir=self.data_dirs[i]) \
                if self.data_dirs else ObjectStore()
            self.nodes.append(RaftNode(f"n{i}", store, peers,
                                       port=raft_ports[i]))
        self.wait_leader(timeout=leader_timeout)
        for node in self.nodes:
            api = APIServer(
                host=self.host,
                store=ReplicatedStore(node,
                                      commit_timeout=self.commit_timeout))
            api.max_replay_lag_s = self.max_replay_lag_s
            self.apis.append(api.start())
        api_urls = {node.node_id: api.url
                    for node, api in zip(self.nodes, self.apis)}
        for api in self.apis:
            api.api_urls = dict(api_urls)
        return self

    def stop(self) -> None:
        for api in self.apis:
            try:
                api.stop()
            except Exception:
                # teardown best effort: one wedged server must not
                # leak the rest
                _LOG.warning("frontdoor api stop failed", exc_info=True)
        self.apis = []
        for node in self.nodes:
            node.stop()
        self.nodes = []

    # ---- topology --------------------------------------------------------

    def wait_leader(self, timeout: float = 30.0) -> RaftNode:
        """Block until exactly one live node leads -> that node. The wide
        default budget absorbs full-suite GIL contention (election
        timeouts stretch under hundreds of suite threads)."""
        import time as _time
        deadline = _time.monotonic() + timeout
        while _time.monotonic() < deadline:
            leaders = [nd for nd in self.nodes
                       if not nd._stop.is_set() and nd.is_leader()]
            if len(leaders) == 1:
                return leaders[0]
            _time.sleep(0.05)
        raise TimeoutError("no single leader elected: "
                           + str([nd.status() for nd in self.nodes]))

    @property
    def endpoints(self) -> list:
        return [api.url for api in self.apis]

    @property
    def leader_api(self):
        """The APIServer fronting the current leader (raises if the
        group is mid-election)."""
        leader = self.wait_leader()
        return self.apis[self.nodes.index(leader)]

    @property
    def replica_apis(self) -> list:
        leader = self.wait_leader()
        return [api for node, api in zip(self.nodes, self.apis)
                if node is not leader]

    def client(self, **kw):
        """A spread HTTPClient over every front-door endpoint."""
        from kubernetes_tpu_torch.client.clientset import HTTPClient
        return HTTPClient(self.endpoints, **kw)


def serve(conn, n: int = 3) -> None:
    """Process entry: a ``FrontDoorCluster`` of ``n`` until told to stop.
    Sends ``{"endpoints": [...], "leader": url}`` on ``conn`` once the
    group has a leader and every APIServer listens; then any message
    received on ``conn`` stops it. Start it with
    ``multiprocessing.get_context("spawn").Process(target=serve,
    args=(child_conn,))``: a parent holding a CUDA context must not fork."""
    fd = FrontDoorCluster(n).start()
    try:
        conn.send({"endpoints": fd.endpoints, "leader": fd.leader_api.url})
        conn.recv()
    except EOFError:
        pass  # the parent went away: stop all the same
    finally:
        fd.stop()
