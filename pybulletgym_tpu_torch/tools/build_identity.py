"""Whether two checkouts build the same CUDA libraries of the default, large, huge and sized classes.

    python3 pybulletgym_tpu_torch/tools/build_identity.py ROOT_A ROOT_B
        [--tasks HalfCheetahPyBulletEnv-v0,HumanoidPyBulletEnv-v0]

For each root, a fresh process (PYTHONPATH=ROOT) builds engine.cu's
libraries of the default and the large class (`cuda_engine.
load_cuda_library(False)` and `(True)`, one per group width G; the huge
class's too where the root has it, and the sized class's at the
ten-Humanoid scene's caps where the root has that scene), for each listed
env ID task_step.cu
with that task's hooks translated (`ops.task_kernel.CudaTaskStep`, its
shipped class taken as a user's task), task_step.cu's large build with the
two-Humanoid scene's task and its huge build with the four-Humanoid scene's
(the root's `chip_smoke.py`; the huge one where the root has
`humanoids_task`), and prints one
JSON line per library: each kernel's ptxas report
(registers, stack frame, spill stores and loads) and the SHA-256 of the
library's SASS (`cuobjdump -sass`: the instructions and their encodings,
each function's name; no addresses, and no anonymous namespace's id,
which nvcc derives from the file's path). The last line says, for each of
ROOT_A's libraries, whether the two roots' ptxas reports and SASS are
equal. Needs
nvcc and cuobjdump (the CUDA toolkit, `cuda_engine.nvcc_path`'s
directory); nothing is launched.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

_CHILD = r"""
import hashlib, json, os, re, subprocess, sys
from pybulletgym_tpu_torch import make_task
from pybulletgym_tpu_torch.ops import cuda_engine as ce
from pybulletgym_tpu_torch.ops import task_kernel as tk

root, tasks = sys.argv[1], [t for t in sys.argv[2].split(",") if t]
cuobjdump = os.path.join(os.path.dirname(ce.nvcc_path()), "cuobjdump")
anon = re.compile(r"_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]+")

def ptxas(log):
    out = []
    for ln in log.splitlines():
        m = re.search(r"entry function '.*?(env_step_kernel|physics_step_kernel|task_step_kernel)", ln)
        if m:
            out.append({"kernel": m.group(1)})
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and out:
            out[-1].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                           spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and out:
            out[-1]["registers"] = int(m.group(1))
    return out

def sass(path):
    text = subprocess.run([cuobjdump, "-sass", path], capture_output=True, text=True,
                          check=True).stdout
    keep = [anon.sub("_GLOBAL__N_", re.sub(r"/\*[0-9a-f]{4,}\*/", "", ln)).strip()
            for ln in text.splitlines() if re.match(r"\s*(/\*[0-9a-f]{4,}\*/|Function :)", ln)]
    return hashlib.sha256("\n".join(keep).encode()).hexdigest(), len(keep)

def report(label, lib, text):
    digest, n = sass(lib._name)
    print(json.dumps({"root": root, "lib": label, "ptxas": ptxas(text), "sass_sha256": digest,
                      "sass_lines": n}), flush=True)

sys.path.insert(0, root)
import chip_smoke as cs
# the classes by the arguments both roots' load_cuda_library take
classes = [("engine", (False,)), ("engine_large", (True,))] + (
    [("engine_huge", (ce.HUGE,))] if hasattr(ce, "HUGE") else [])
if hasattr(ce, "SIZED") and hasattr(cs, "humanoids_task"):
    ten = cs.humanoids_task(cs.humanoids_xml(10), 10)
    classes.append(("engine_sized", (ce.SIZED, ce.tables_caps(
        ce.pack_physics(ten.model, ten.physics)))))
for kind, args in classes:
    libs, log = ce.load_cuda_library(*args)
    sections = log.split("== G=")[1:]
    for G, lib in sorted(libs.items()):
        report(f"{kind} G={G}", lib, next(s for s in sections if s.startswith(f"{G}\n")))
if hasattr(cs, "humanoids_task"):
    scenes = [(f"{name}-v0", cs.humanoids_task(cs.humanoids_xml(n), n))
              for name, n in (("TwoHumanoids", 2), ("FourHumanoids", 4))]
else:
    scenes = [("TwoHumanoids-v0", cs.two_humanoid_task(cs.two_humanoids_xml()))]
for env_id, task in [(e, make_task(e)) for e in tasks] + scenes:
    st = tk.CudaTaskStep(task)
    st.prepare()
    lib, text = st.library()
    report(f"task {env_id} G={st.tables.lanes}", lib, text)
"""


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("roots", nargs=2)
    p.add_argument("--tasks", default="HalfCheetahPyBulletEnv-v0,HumanoidPyBulletEnv-v0")
    args = p.parse_args(argv)
    found = {}
    for root in (os.path.abspath(r) for r in args.roots):
        env = dict(os.environ, PYTHONPATH=root)
        out = subprocess.run([sys.executable, "-c", _CHILD, root, args.tasks], cwd=root,
                             env=env, check=True, capture_output=True, text=True).stdout
        print(out, end="", flush=True)
        found[root] = {r["lib"]: r for r in map(json.loads, out.splitlines())}
    a, b = found.values()
    same = {lib: {"ptxas": a[lib]["ptxas"] == b.get(lib, {}).get("ptxas"),
                  "sass": a[lib]["sass_sha256"] == b.get(lib, {}).get("sass_sha256")}
            for lib in a}
    print(json.dumps({"identical": all(x["ptxas"] and x["sass"] for x in same.values()),
                      "libraries": same}), flush=True)


if __name__ == "__main__":
    main()
