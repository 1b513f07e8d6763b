"""What the compiler made of ``csrc/fused_stats.cu``: per kernel its
registers, shared memory and spills (``nvcc -Xptxas -v``), and how its
global loads are grouped in the machine code (``cuobjdump -sass``).

Run on a machine with the CUDA toolkit, from the repository root:

    python -m dvo_slam_tpu_torch.tools.kernel_report [--kernel gram_kernel]

A thread of launch 1 should start its 7 refpack loads together and then its
28 quad-table loads together, before it uses any: the report lists, per
kernel, the runs of global loads (``LDG``) that no more than ``--gap``
other instructions separate, as [first instruction, last instruction,
loads].  Prints one JSON object per line: the library, then one line per
kernel whose name contains ``--kernel`` with its registers, shared memory,
stack and spills and its runs of loads.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess

from .. import _build


def load_runs(sass: str, gap: int):
    """{kernel: [[first, last, loads], ...]} from ``cuobjdump -sass`` text."""
    kernels, name, index, runs = {}, None, 0, []
    for line in sass.splitlines():
        started = re.search(r"Function : (\S+)", line)
        if started:
            if name is not None:
                kernels[name] = runs
            name, index, runs = started.group(1), 0, []
            continue
        instruction = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\d+\s+)?([A-Z0-9_.]+)", line)
        if name is None or not instruction:
            continue
        if instruction.group(1).startswith("LDG"):
            if runs and index - runs[-1][1] <= gap:
                runs[-1][1] = index
                runs[-1][2] += 1
            else:
                runs.append([index, index, 1])
        index += 1
    if name is not None:
        kernels[name] = runs
    return kernels


def ptxas_summary(log: str):
    """{mangled kernel: {registers, smem, stack, spill_stores, spill_loads}}
    from the output of ``nvcc -Xptxas -v``."""
    out, name = {}, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            name = entry.group(1)
            out[name] = {}
            continue
        if name is None:
            continue
        stack = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
        if stack:
            out[name].update(zip(("stack", "spill_stores", "spill_loads"), map(int, stack.groups())))
        used = re.search(r"Used (\d+) registers", line)
        if used:
            smem = re.search(r"(\d+) bytes smem", line)
            out[name].update(registers=int(used.group(1)), smem=int(smem.group(1)) if smem else 0)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", default="gram_kernel")
    ap.add_argument("--gap", type=int, default=8)
    args = ap.parse_args()
    library = _build.load_library("fused_stats")
    print(json.dumps({"library": os.path.basename(library.path),
                      "build_seconds": library.build_seconds}), flush=True)
    resources = ptxas_summary(library.compiler_log)
    cuobjdump = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(_build.find_nvcc()), "cuobjdump")
    if not os.path.exists(cuobjdump):
        for name, used in resources.items():
            print(json.dumps({"kernel": name, **used, "global_load_runs": "not measured"}), flush=True)
        return
    sass = subprocess.run([cuobjdump, "-sass", library.path], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    demangle = shutil.which("cu++filt") or os.path.join(os.path.dirname(cuobjdump), "cu++filt")
    for name, runs in load_runs(sass, args.gap).items():
        shown = name
        if os.path.exists(demangle):
            shown = subprocess.run([demangle, name], capture_output=True, text=True,
                                   timeout=60).stdout.strip() or name
        if args.kernel in shown:
            print(json.dumps({"kernel": shown, **resources.get(name, {}),
                              "global_load_runs": runs}), flush=True)


if __name__ == "__main__":
    main()
