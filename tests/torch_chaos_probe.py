"""Run ``chip_smoke.py``'s chaos, scenario and ktpu phases alone on the card.

    python3 tests/torch_chaos_probe.py [OUT]

Builds the kernels, then runs ``chaos_phase`` (ChaosChurnQueued, with
``SchedulerKill`` started before it and joined after it),
``scenario_phase`` and ``ktpu_phase`` one after another, each timed; a
phase that fails is reported and the next one runs. Everything each phase returned goes to OUT as JSON (default
``build/chaos_probe.json``); the last lines print the chaos legs'
recovery, stages and gates, and the scenario replay's. Needs a CUDA card
(a few minutes on one H100).
"""

import json
import os
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def main(out_path) -> int:
    from kubernetes_tpu_torch.ops import kernels
    smi = cs.nvidia_smi_line()
    print(smi, flush=True)
    t = time.perf_counter()
    kernels.build()
    print("build", round(time.perf_counter() - t, 1), flush=True)
    out = {"smi": smi}
    rc = 0
    kill = cs.SchedulerKill(smi=smi).start()

    def chaos():
        try:
            return cs.chaos_phase(smi=smi)
        finally:
            out["kill"] = kill.join()

    for name, fn in (("chaos", chaos),
                     ("scenario", lambda: cs.scenario_phase(smi=smi)),
                     ("ktpu", cs.ktpu_phase)):
        t = time.perf_counter()
        try:
            out[name] = fn()
            print(name, "ok", round(time.perf_counter() - t, 1), flush=True)
        except Exception as e:  # reported; the next phase still runs
            traceback.print_exc()
            out[name] = {"error": repr(e)}
            rc = 1
            print(name, "FAILED", round(time.perf_counter() - t, 1),
                  repr(e)[:2000], flush=True)
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(out, f, indent=1, default=str)
    churn = out.get("chaos", {}).get("churn", {})
    print(json.dumps({k: churn.get(k) for k in (
        "cell", "recovery", "peeks", "unreached", "stages", "settle_s",
        "breaker_state", "window_s", "pods_per_s", "oracle_pods",
        "loop_errors_by_site", "bind_retries", "failures", "seconds")},
        default=str))
    kill = out.get("kill", {})
    print(json.dumps({k: kill.get(k) for k in (
        "cold_boot_s", "restart_total_s", "first_bind_after_restart_s",
        "failures", "seconds")}, default=str))
    scen = out.get("scenario", {})
    print(json.dumps({k: scen.get(k) for k in (
        "bound", "resident", "phases", "failures", "seconds", "launches")},
        default=str))
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1
                  else os.path.join(ROOT, "build", "chaos_probe.json")))
