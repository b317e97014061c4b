"""Compare two trees of the PyTorch port on one NVIDIA H100: the 4-layer
7B-width Llama train step, the Mamba-130m train step and the contiguous
bf16 engine's TTFT p50, each from that tree's own ``chip_smoke.py``; with
``--serving``, the serving side alone: the contiguous engine's TTFT p50
and decode tok/s, and ``obs_7b_phase``'s TPOT p50 and TTFT p50 with
telemetry off and on (the paged 7B-width engine, medians of 5 runs).

    python3 chip_ab.py PARENT_DIR CHANGE_DIR [--out DIR] [--serving]

Both directories hold a whole tree (for instance unpacked with ``git
archive``). Each run is a process of its own, in the order parent,
change, change, parent, that builds the kernels (or reuses a library of
the same sources an earlier run built), then calls ``build_7b`` and
``engine_phase``, ``train_7b_phase`` and ``mamba_train_phase``, with TF32
off as ``chip_smoke.main`` sets it. A run's whole output goes to
``DIR/ab_<n>_<tree>.log`` (``build/ab`` by default); one JSON line per
run is printed, then a last line with each tree's two values of each
metric. Exits non-zero, with no result, without a card.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

RUN = """
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
import chip_smoke as c
from paddle_tpu_torch.kernels import _build
_build.build()
model, prompts = c.build_7b()
c.engine_phase(model, prompts)
del model, prompts
torch.cuda.empty_cache()
c.train_7b_phase()
torch.cuda.empty_cache()
c.mamba_train_phase()
"""

RUN_SERVING = """
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
import chip_smoke as c
from paddle_tpu_torch.kernels import _build
_build.build()
model, prompts = c.build_7b()
c.engine_phase(model, prompts)
c.obs_7b_phase(model, prompts)
"""

# the JSON line each phase prints, and the numbers this script reads there
# (a dotted path into the line's document)
METRICS = {"engine": ["ttft_p50_ms"], "train_7b": ["step_ms_median"],
           "train_mamba130m": ["step_ms_median"]}
METRICS_SERVING = {
    "engine": ["ttft_p50_ms", "decode_tokens_per_s"],
    "obs_7b": ["medians.off.tpot_p50_ms", "medians.on.tpot_p50_ms",
               "medians.off.ttft_p50_ms", "medians.on.ttft_p50_ms"]}


def share_builds(trees):
    """Copy each built kernel library into the trees that lack a build of
    the same sources (the directory name is the hash of the sources)."""
    roots = [t / "paddle_tpu_torch" / "kernels" / "_build" for t in trees]
    for src in roots:
        for built in (src.glob("*/") if src.is_dir() else ()):
            for dst in roots:
                if dst != src and not (dst / built.name).exists():
                    shutil.copytree(built, dst / built.name)


def run(tree: Path, log: Path, timeout: int, code: str,
        metrics: dict) -> dict:
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-c", code], cwd=tree,
                         capture_output=True, text=True, timeout=timeout)
    log.write_text(res.stdout + "\n--- stderr ---\n" + res.stderr)
    if res.returncode != 0:
        raise RuntimeError(f"{tree}: exit {res.returncode}; see {log}")
    out = {"tree": str(tree), "seconds": time.perf_counter() - t0}
    for line in res.stdout.splitlines():
        if not line.startswith("{"):
            continue
        doc = json.loads(line)
        for key, fields in metrics.items():
            for field in fields if key in doc else ():
                val = doc[key]
                for part in field.split("."):
                    val = val[part]
                out[f"{key}.{field}"] = val
    missing = [f"{k}.{f}" for k, fs in metrics.items() for f in fs
               if f"{k}.{f}" not in out]
    if missing:
        raise RuntimeError(f"{tree}: no {missing} in the output; see {log}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent", type=Path)
    ap.add_argument("change", type=Path)
    ap.add_argument("--out", type=Path, default=Path("build") / "ab")
    ap.add_argument("--timeout", type=int, default=900)
    ap.add_argument("--serving", action="store_true",
                    help="the serving metrics alone (engine and obs_7b)")
    args = ap.parse_args()
    code, metrics = ((RUN_SERVING, METRICS_SERVING) if args.serving
                     else (RUN, METRICS))
    import torch

    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device is available", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi, flush=True)
    args.out.mkdir(parents=True, exist_ok=True)
    trees = {"parent": args.parent.resolve(), "change": args.change.resolve()}
    runs = []
    for i, name in enumerate(("parent", "change", "change", "parent")):
        r = run(trees[name], args.out / f"ab_{i}_{name}.log", args.timeout,
                code, metrics)
        r["name"] = name
        print(json.dumps(r), flush=True)
        runs.append(r)
        share_builds(list(trees.values()))
    summary = {}
    for name in trees:
        mine = [r for r in runs if r["name"] == name]
        summary[name] = {m: [r[m] for r in mine] for m in mine[0]
                         if "." in m}
    print(smi, flush=True)
    print(json.dumps({"ab": summary, "device": {
        "kind": torch.cuda.get_device_name(0),
        "power_limit": smi.split(",")[-1].strip()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
