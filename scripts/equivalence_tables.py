#!/usr/bin/env python3
"""The five tables of docs/EQUIVALENCE_TORCH.md on one card, their rows run
by several processes at once (``scripts/equivalence_run.py``).

    python3 scripts/equivalence_tables.py [--seeds 0 1 2] [--workdir DIR]
        [--out docs/EQUIVALENCE_TORCH.md] [--commit TEXT] [--quick] [--device cpu]

Both stacks are bound by the host (the torch stack's PIL transforms on one
thread, run()'s transform launches and its PNG decode), and the card idles
most of each run, so the rows run in parallel: one process writes the
dataset and trains the teacher, then each job (``JOBS``, in its own
workdir sharing that dataset and teacher) runs its rows, each row exactly
what ``equivalence_run.py`` runs alone. The jobs' results caches are merged
and the tables written from them (every row cached). One more job runs
two of the rows again (``REPEAT``: a torch row and an ours row) to show
whether a row repeats its digits. ``--quick`` and the size options pass
through to ``equivalence_run.py``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

# (recipe, ours' dtype, ours' bf16 pixel stage, objectives)
TABLES = (("base", "bfloat16", False, "all"),
          ("base", "float32", False, "both"),
          ("ra", "bfloat16", False, "both"),
          ("ra", "bfloat16", True, "soft"),
          ("3aug", "bfloat16", False, "soft"))
# each job: the (recipe, dtype, pixel stage, objective) groups it runs in turn;
# a table's torch rows come from the group that runs them first (the cache
# key leaves ours' settings out)
JOBS = ((("base", "bfloat16", False, "soft"), ("base", "float32", False, "soft")),
        (("base", "bfloat16", False, "mgd"), ("base", "float32", False, "mgd")),
        (("base", "bfloat16", False, "wasskd"), ("3aug", "bfloat16", False, "soft")),
        (("base", "bfloat16", False, "vitkd"), ("ra", "bfloat16", False, "soft")),
        (("ra", "bfloat16", False, "mgd"), ("ra", "bfloat16", True, "soft")))
REPEAT = ("base", "bfloat16", False, "soft")   # its first seed, run again


def _flags(recipe, dtype, pixel_bf16, objective):
    return (["--recipe", recipe, "--dtype", dtype, "--objective", objective]
            + (["--ours-pixel-bf16"] if pixel_bf16 else []))


def _link_shared(base, workdir):
    os.makedirs(workdir, exist_ok=True)
    for name in ("data", "teacher.pth", "teacher_acc.json"):
        dst = os.path.join(workdir, name)
        if not os.path.lexists(dst):
            os.symlink(os.path.join(base, name), dst)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", nargs="+", default=["0", "1", "2"])
    ap.add_argument("--workdir", default=os.path.join(tempfile.gettempdir(),
                                                      "deltakd_torch_equivalence_tables"))
    ap.add_argument("--out", default=None)
    ap.add_argument("--commit", default=None)
    ap.add_argument("--job", default=None, help=argparse.SUPPRESS)
    args, passed = ap.parse_known_args(argv)
    import equivalence_run as eq

    if args.job:   # one job's groups in turn: a crash fails it, a verdict does not
        for group in json.loads(args.job):
            eq.compare(group)
        return 0

    common = passed + (["--commit", args.commit] if args.commit else [])
    base = os.path.join(args.workdir, "shared")
    t0 = time.time()
    eq.compare(common + ["--prepare", "--workdir", base])
    print(f"[tables] dataset and teacher in {time.time() - t0:.0f} s", flush=True)

    env = dict(os.environ, OMP_NUM_THREADS="2")   # six processes share the host's cores
    jobs = [(f"job{i}", groups, args.seeds) for i, groups in enumerate(JOBS)]
    jobs.append(("repeat", (REPEAT,), args.seeds[:1]))
    procs = []
    for name, groups, seeds in jobs:
        workdir = os.path.join(args.workdir, name)
        _link_shared(base, workdir)
        calls = [[*_flags(*g), "--seeds", *seeds, "--workdir", workdir,
                  "--out", os.path.join(workdir, "tables.md"), *common] for g in groups]
        log = open(os.path.join(workdir, "log.txt"), "w")
        procs.append((name, workdir, subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--job", json.dumps(calls)],
            stdout=log, stderr=subprocess.STDOUT, env=env), log))
    failed = []
    for name, workdir, proc, log in procs:
        rc = proc.wait()
        log.close()
        print(f"[tables] {name}: exit {rc} after {time.time() - t0:.0f} s", flush=True)
        if rc:
            failed.append(name)
            with open(os.path.join(workdir, "log.txt")) as f:
                print("".join(f.readlines()[-30:]), flush=True)
    if failed:
        raise SystemExit(f"[tables] jobs failed: {failed}")

    final = os.path.join(args.workdir, "final")
    _link_shared(base, final)
    merged = {}
    for name, workdir, _, _ in procs:
        with open(os.path.join(workdir, "results_cache.json")) as f:
            rows = json.load(f)
        if name == "repeat":
            repeat = rows
            continue
        merged.update(rows)
    with open(os.path.join(final, "results_cache.json"), "w") as f:
        json.dump(merged, f, indent=1)
    for key, row in sorted(repeat.items()):
        was = merged[key]
        same = all(f"{was[k]:.2f}" == f"{row[k]:.2f}" for k in ("final_acc", "best_acc"))
        print(f"[repeat] {key}: final {was['final_acc']:.2f} best {was['best_acc']:.2f}, "
              f"again final {row['final_acc']:.2f} best {row['best_acc']:.2f}: "
              f"{'repeats its digits' if same else 'DIFFERS'}", flush=True)

    out = {}
    for table in TABLES:
        got = eq.compare(common + _flags(*table) + ["--seeds", *args.seeds, "--workdir", final]
                         + (["--out", args.out] if args.out else []))
        out[table] = got["verdicts"]
    print("[tables] verdicts: " + "; ".join(
        f"{r} {d}{' pixel bf16' if p else ''}: " + ", ".join(
            f"{k} {v[2]} (delta {v[0]:.2f}, band {v[1]:.2f})" for k, v in verdicts.items())
        for (r, d, p, _), verdicts in out.items()), flush=True)
    print(f"[tables] {time.time() - t0:.0f} s in all", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
