"""Runs of benchmark cells from unpacked checkouts, one process a run, and
the medians and spreads of their sets, from which the bounds in
``BENCHMARK.json`` are set.

    python3 benchmark/sets.py plan <cell> <base_seed>
    python3 benchmark/sets.py run --out <dir> [--env <dir>] --checkout parent=<dir> \\
        --checkout change=<dir> <side>:<cell>:<seed>:<trace>:<seconds> ...
    python3 benchmark/sets.py summary <dir>

``plan`` prints a cell's run list: parent and change on two seeds in the
order P C C P, the change's two sets of 6 runs on the same 6 seeds, 3 traced
change runs and 1 traced parent run, and 3 short runs on further seeds, all
at 51 s but the last. ``run`` runs each spec from its side's checkout with
``HOME``, ``XDG_CACHE_HOME`` and ``TMPDIR`` of that side's own under
``--env`` (``<out>/env`` by default), and writes one record a run to
``--out``: the result line, the ``check:`` lines and the end of standard
error. ``summary`` reads the
records: whether every run was correct, whether parent and change print the
same ``check:`` lines on a seed, each metric's median and spread (first to
third quartile over the median, by ``statistics.quantiles``) in set A (the
first 6 untraced change runs of at least 40 s), set B (the next 6) and both,
and the per-layer names each side's traced runs report.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

SET_RUNS = 6
FULL_S = 51


def plan(cell: str, base: int) -> list[str]:
    s = [base + k for k in range(1, SET_RUNS + 1)]
    t = [base + 10 + k for k in range(1, 4)]
    x = [base + 20 + k for k in range(1, 4)]
    runs = [f"parent:{cell}:{s[0]}:0:{FULL_S}", f"change:{cell}:{s[0]}:0:{FULL_S}",
            f"change:{cell}:{s[1]}:0:{FULL_S}", f"parent:{cell}:{s[1]}:0:{FULL_S}"]
    runs += [f"change:{cell}:{k}:0:{FULL_S}" for k in s[2:]]
    runs += [f"change:{cell}:{k}:0:{FULL_S}" for k in s]
    runs += [f"change:{cell}:{k}:1:{FULL_S}" for k in t] + [f"parent:{cell}:{t[0]}:1:{FULL_S}"]
    return runs + [f"change:{cell}:{k}:0:5" for k in x]


def card() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "no nvidia-smi"
    return r.stdout.strip()


def run(out: Path, env_root: Path, checkouts: dict, specs: list[str]) -> None:
    out.mkdir(parents=True, exist_ok=True)
    print("card:", card(), flush=True)
    for i, spec in enumerate(specs):
        side, cell, seed, trace, seconds = spec.split(":")
        env = dict(os.environ)
        for key, sub in (("HOME", "home"), ("XDG_CACHE_HOME", "cache"), ("TMPDIR", "tmp")):
            d = (env_root / side / sub).resolve()
            d.mkdir(parents=True, exist_ok=True)
            env[key] = str(d)
        t = time.perf_counter()
        try:
            p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell,
                                "--seed", seed, "--seconds", seconds, "--trace", trace],
                               cwd=checkouts[side], env=env, capture_output=True, text=True,
                               timeout=1300)
            rc, stdout, stderr = p.returncode, p.stdout, p.stderr
        except subprocess.TimeoutExpired:
            rc, stdout, stderr = 124, "", "timed out"
        lines = stdout.strip().splitlines()
        try:
            result = json.loads(lines[-1]) if lines else None
        except ValueError:
            result = None
        rec = {"index": i, "side": side, "cell": cell, "seed": int(seed), "trace": int(trace),
               "seconds": float(seconds), "rc": rc, "wall_s": time.perf_counter() - t,
               "result": result,
               "checks": [x for x in stderr.splitlines() if x.startswith("check:")
                          and " limit " in x],
               "stderr_tail": stderr[-6000:]}
        (out / f"{i:02d}_{side}_{cell}_{seed}_{trace}.json").write_text(json.dumps(rec))
        brief = {k: rec[k] for k in ("side", "cell", "seed", "trace", "rc")}
        brief["wall_s"] = round(rec["wall_s"], 1)
        if result:
            brief.update(correct=result["correct"],
                         metrics={k: v["value"] for k, v in result["metrics"].items()})
        else:
            brief["stderr"] = stderr[-1500:]
        print(json.dumps(brief), flush=True)
    print("card:", card(), flush=True)


def spread(values: list[float]) -> float:
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def summary(out: Path) -> None:
    recs = sorted((json.loads(p.read_text()) for p in out.glob("*.json")),
                  key=lambda r: r["index"])
    for cell in sorted({r["cell"] for r in recs}):
        runs = [r for r in recs if r["cell"] == cell]
        ok = all(r["result"] and r["result"]["correct"] for r in runs)
        print(f"== {cell}: {len(runs)} runs, all correct: {ok}")
        parent = {r["seed"]: r for r in runs if r["side"] == "parent" and r["trace"] == 0}
        change = [r for r in runs if r["side"] == "change" and r["trace"] == 0 and r["result"]]
        for seed, p in parent.items():
            c = next((r for r in change if r["seed"] == seed), None)
            if c is not None and p["result"]:
                print(f"  seed {seed}: check lines the same: {p['checks'] == c['checks']};",
                      {k: (v["value"], c["result"]["metrics"][k]["value"])
                       for k, v in p["result"]["metrics"].items()})
        full = [r for r in change if r["seconds"] >= 40]
        sets = {"A": full[:SET_RUNS], "B": full[SET_RUNS:2 * SET_RUNS]}
        if len(sets["B"]) == SET_RUNS:
            for k in sets["A"][0]["result"]["metrics"]:
                line = []
                for name, rs in (*sets.items(), ("both", sets["A"] + sets["B"])):
                    v = [r["result"]["metrics"][k]["value"] for r in rs]
                    line.append(f"{name} median {statistics.median(v):.6g} "
                                f"spread {spread(v):.4%}")
                print(f"  {k}: " + "; ".join(line))
        for side in ("parent", "change"):
            names = {tuple(sorted(r["result"]["metrics"])) for r in runs
                     if r["side"] == side and r["trace"] == 1 and r["result"]}
            print(f"  traced {side}: {sorted(names)}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("plan")
    p.add_argument("cell")
    p.add_argument("base", type=int)
    r = sub.add_parser("run")
    r.add_argument("--out", type=Path, required=True)
    r.add_argument("--env", type=Path)
    r.add_argument("--checkout", action="append", default=[])
    r.add_argument("specs", nargs="+")
    s = sub.add_parser("summary")
    s.add_argument("out", type=Path)
    args = ap.parse_args(argv)
    if args.cmd == "plan":
        print(" ".join(plan(args.cell, args.base)))
    elif args.cmd == "run":
        run(args.out, args.env or args.out / "env", dict(c.split("=", 1) for c in args.checkout),
            args.specs)
    else:
        summary(args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
