"""The card script's ``ktpu`` phase, rehearsed on the CPU: the port's
``ktpu`` against the port's APIServer, a SchedulerRunner on
``device="cpu"`` and a served hollow kubelet. Every command exits 0 and
its gate holds; ``logs``, ``attach``, ``exec`` and ``port-forward`` reach
the pod the runner bound to the hollow kubelet through the apiserver's
proxies."""

from __future__ import annotations

import chip_smoke


def test_chip_smoke_ktpu_phase_runs_on_the_cpu():
    out = chip_smoke.ktpu_phase(device="cpu")
    commands = out["commands"]
    assert {"logs", "attach", "exec", "port_forward"} <= set(commands)
    assert all(c["rc"] == 0 for c in commands.values())
    assert commands["exec"]["bytes"] == len("hello kubelet\n")
    assert commands["port_forward"]["bytes"] > len("echo: ping")
