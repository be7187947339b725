"""Parent against change on the card: ``chip_smoke.py``'s ``ktpu`` phase
(parent, change, change, parent), then its ``controllers`` phase (parent,
change), each in a process of its own started in that checkout. JAX-free;
run it on a machine with an H100 from the root of the change's checkout,
with the parent unpacked into a directory that ``.gitignore`` lists::

    git archive <parent> | tar -x -C build/parent
    python3 tests/torch_phase_ab.py build/parent [OUT]

Prints each run's seconds, step seconds, step 1's pods/s and each
process's CPU seconds a step, and writes every summary to ``OUT``
(``build/ab.json`` unless given)."""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN = r'''
import json, sys, time
import chip_smoke as cs
if __name__ == "__main__":
    t = time.perf_counter()
    if sys.argv[1] == "ktpu":
        out = cs.ktpu_phase()
    else:
        out = cs.controllers_phase(smi=cs.nvidia_smi_line())
    out["wall_s"] = time.perf_counter() - t
    print("RESULT " + json.dumps(out, default=str), flush=True)
'''
ORDER = (("ktpu", "parent"), ("ktpu", "change"), ("ktpu", "change"),
         ("ktpu", "parent"), ("controllers", "parent"),
         ("controllers", "change"))


def main(parent: str, out: str) -> int:
    trees = {"parent": os.path.abspath(parent), "change": ROOT}
    results = []
    for phase, tree in ORDER:
        p = subprocess.run([sys.executable, "-c", RUN, phase],
                           cwd=trees[tree], capture_output=True, text=True,
                           timeout=400)
        line = [ln for ln in p.stdout.splitlines()
                if ln.startswith("RESULT ")]
        res = (json.loads(line[-1][len("RESULT "):]) if line else
               {"rc": p.returncode, "err": p.stderr[-2000:]})
        results.append({"phase": phase, "tree": tree, **res})
        print(phase, tree, json.dumps(
            {k: res.get(k) for k in ("wall_s", "seconds", "steps_s",
                                     "pods_per_s", "steps_cpu_s", "err")},
            default=str), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(results, f, indent=1, default=str)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0 if all("err" not in r for r in results) else 1


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1], sys.argv[2] if len(sys.argv) > 2
                          else os.path.join(ROOT, "build", "ab.json")))
