"""``ktpu-up``'s library form on both packages, on the CPU.

Every case of ``tests/test_cluster_up.py`` (6) runs on both packages
through ``tests/torch_store_parity.py``: the three ``LocalCluster`` cases
(a Deployment scheduled and Running on hollow kubelets, the minted admin
credential behind auth, ``join``) with the port's cluster bound to the
CPU (``LocalCluster(device="cpu")``), and the three sanity cases with the
port's ``evaluate`` on CPU tensors. Both pass, and their records are
equal: the module is ``RECONCILED`` and ``POLLED`` (the cluster's
manager, scheduler and kubelets work on threads of their own while the
case polls), so the record keeps the case's writes and their answers.
Then ``ktpu-up`` itself: ``main`` prints the scheduler's device on a line
before ``control plane up:``.
"""

from __future__ import annotations

import io
import re
import threading
import time

import pytest

import torch_store_parity as parity

NAME = "test_cluster_up"
CASES = parity.cases(NAME)


@pytest.fixture(scope="module")
def shared():
    yield from parity.shared_fixtures()


@pytest.mark.parametrize("fname,params", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_reference_case_on_both_packages(fname, params, tmp_path, shared):
    ref, port = parity.both(NAME, fname, params, tmp_path, shared)
    assert port == ref


def test_cluster_up_cases_are_selected():
    assert len(CASES) == 6


def test_ktpu_up_init_prints_its_device_then_joins(monkeypatch):
    """``ktpu-up init --device cpu`` prints ``device: cpu`` on the line
    before ``control plane up:``, the reference's lines after it; ``join``
    against it registers its workers; both return 0 once stopped."""
    from kubernetes_tpu_torch.cli import cluster
    from kubernetes_tpu_torch.client.clientset import HTTPClient
    handlers = []   # (signal, handler) of each main, run on its thread

    monkeypatch.setattr(cluster.signal, "signal",
                        lambda sig, fn: handlers.append((sig, fn)))
    outs = [io.StringIO(), io.StringIO()]
    rcs = {}
    init = threading.Thread(target=lambda: rcs.setdefault("init", cluster.main(
        ["init", "--nodes", "1", "--device", "cpu", "--auth"], out=outs[0])),
        daemon=True)
    init.start()
    end = time.monotonic() + 60
    while "nodes:" not in outs[0].getvalue() and time.monotonic() < end:
        time.sleep(0.05)
    lines = outs[0].getvalue().splitlines()
    assert lines[0] == "device: cpu"
    assert lines[1].startswith("control plane up: http://127.0.0.1:")
    assert re.fullmatch(r"admin token: ktpu-admin-[0-9a-f]{32}", lines[2])
    assert lines[3] == "nodes: ['node-0']"
    url = lines[1].split(": ", 1)[1]
    token = lines[2].split(": ", 1)[1]
    join = threading.Thread(target=lambda: rcs.setdefault("join", cluster.main(
        ["join", "--server", url, "--nodes", "2", "--token", token],
        out=outs[1])), daemon=True)
    join.start()
    client = HTTPClient(url, token=token)
    while time.monotonic() < end and (len(client.nodes().list()) < 3
                                      or "joined:" not in outs[1].getvalue()):
        time.sleep(0.05)
    assert sorted(n["metadata"]["name"] for n in client.nodes().list()) \
        == ["node-0", "worker-0", "worker-1"]
    assert outs[1].getvalue() == "joined: ['worker-0', 'worker-1']\n"
    import signal
    for sig, fn in handlers:
        if sig == signal.SIGTERM:
            fn(sig, None)
    init.join(30)
    join.join(30)
    assert rcs == {"init": 0, "join": 0}
