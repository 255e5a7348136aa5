"""Local hyperparameter sweep runner (``deltakd_tpu/cli/sweep.py``), without
wandb.

The reference's only sweep path is a wandb Bayesian agent driving
``exp/lrkd-deit-tiny-sweep.sh`` through environment variables (reference
exp/lrkd_sweep_config.yaml:1-8, SURVEY.md §3.6). This runner executes the
same sweep-config format locally and honours its ``method:`` key: ``bayes``
runs Gaussian-process expected-improvement search (random for the first few
trials, then a GP surrogate over the normalised parameter space proposes
each next trial); ``random`` samples. For the same ``--seed`` it draws the
same trials as the JAX package's runner. Results land in a JSONL file.

    python -m deltakd_tpu_torch.cli.sweep --config exp/lrkd_sweep_config.yaml \
        --trials 8 -- --dataset cifar-100 --data-path dataset --epochs 20
"""

from __future__ import annotations

import argparse
import json
import math
import random
import sys
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np


def _load_yaml(path: str) -> Dict[str, Any]:
    try:
        import yaml

        with open(path) as f:
            return yaml.safe_load(f)
    except ImportError:
        # minimal parser for the sweep-config subset we emit (two-space
        # indentation, scalars / lists / nested maps)
        return _mini_yaml(path)


def _mini_yaml(path: str) -> Dict[str, Any]:
    root: Dict[str, Any] = {}
    stack = [(-1, root)]
    with open(path) as f:
        for raw in f:
            line = raw.rstrip()
            if not line or line.lstrip().startswith("#"):
                continue
            indent = len(line) - len(line.lstrip())
            key, _, value = line.lstrip().partition(":")
            while stack and indent <= stack[-1][0]:
                stack.pop()
            parent = stack[-1][1]
            value = value.strip()
            if not value:
                node: Dict[str, Any] = {}
                parent[key] = node
                stack.append((indent, node))
            else:
                parent[key] = _parse_scalar(value)
    return root


def _parse_scalar(v: str) -> Any:
    if v.startswith("[") and v.endswith("]"):
        return [_parse_scalar(x.strip()) for x in v[1:-1].split(",") if x.strip()]
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            pass
    return v


def sample_params(spec: Dict[str, Any], rng: random.Random) -> Dict[str, Any]:
    out = {}
    for name, p in spec.items():
        if "values" in p:
            out[name] = rng.choice(p["values"])
        elif p.get("distribution") == "uniform":
            out[name] = rng.uniform(p["min"], p["max"])
        elif "value" in p:
            out[name] = p["value"]
        else:
            raise ValueError(f"Unsupported parameter spec for {name}: {p}")
    return out


# -----------------------------------------------------------------------------
# Bayesian (GP-EI) search over the sweep space
# -----------------------------------------------------------------------------

def _tunable(spec: Dict[str, Any]) -> List[str]:
    return [n for n, p in spec.items() if "values" in p
            or p.get("distribution") == "uniform"]


def _encode(spec: Dict[str, Any], params: Dict[str, Any]) -> np.ndarray:
    """Map one param dict onto the unit cube (values lists → index grid)."""
    xs = []
    for name in _tunable(spec):
        p = spec[name]
        if "values" in p:
            vals = p["values"]
            xs.append(vals.index(params[name]) / max(len(vals) - 1, 1))
        else:
            xs.append((params[name] - p["min"]) / (p["max"] - p["min"]))
    return np.asarray(xs, np.float64)


def _decode(spec: Dict[str, Any], x: np.ndarray) -> Dict[str, Any]:
    out = {}
    i = 0
    for name, p in spec.items():
        if "values" in p:
            vals = p["values"]
            out[name] = vals[int(round(np.clip(x[i], 0, 1) * (len(vals) - 1)))]
            i += 1
        elif p.get("distribution") == "uniform":
            out[name] = float(p["min"] + np.clip(x[i], 0, 1) * (p["max"] - p["min"]))
            i += 1
        elif "value" in p:
            out[name] = p["value"]
    return out


def bayes_suggest(spec: Dict[str, Any],
                  history: Sequence[Tuple[Dict[str, Any], float]],
                  rng: random.Random, *, n_init: int = 4,
                  n_candidates: int = 512) -> Dict[str, Any]:
    """Next trial via GP expected improvement (maximization).

    RBF-kernel GP on unit-cube-encoded params with standardized scores; EI
    maximized over random candidates. Falls back to random sampling for the
    first ``n_init`` trials (nothing to fit yet) — the same structure as
    wandb's Bayes agent over this config format."""
    if len(history) < n_init:
        return sample_params(spec, rng)
    X = np.stack([_encode(spec, p) for p, _ in history])
    y = np.asarray([s for _, s in history], np.float64)
    y_std = y.std() or 1.0
    yn = (y - y.mean()) / y_std

    d = X.shape[1]
    ell, noise = 0.3 * math.sqrt(d), 1e-4

    def k(a, b):
        d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
        return np.exp(-0.5 * d2 / (ell * ell))

    K = k(X, X) + noise * np.eye(len(X))
    L = np.linalg.cholesky(K)
    alpha = np.linalg.solve(L.T, np.linalg.solve(L, yn))

    np_rng = np.random.RandomState(rng.randrange(2 ** 31))
    cand = np_rng.uniform(0, 1, (n_candidates, d))
    Ks = k(cand, X)
    mu = Ks @ alpha
    v = np.linalg.solve(L, Ks.T)
    var = np.clip(1.0 - (v ** 2).sum(0), 1e-12, None)
    sigma = np.sqrt(var)

    best = yn.max()
    z = (mu - best) / sigma
    # standard-normal pdf/cdf without scipy
    pdf = np.exp(-0.5 * z * z) / math.sqrt(2 * math.pi)
    cdf = 0.5 * (1.0 + np.vectorize(math.erf)(z / math.sqrt(2)))
    ei = (mu - best) * cdf + sigma * pdf
    return _decode(spec, cand[int(ei.argmax())])


def main(argv=None):
    parser = argparse.ArgumentParser(description="Local sweep runner")
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--trials", type=int, default=8)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--output", type=str, default="sweep_results.jsonl")
    parser.add_argument("--method", type=str, default=None,
                        choices=["random", "bayes"],
                        help="overrides the config's method: key")
    args, passthrough = parser.parse_known_args(argv)
    if passthrough and passthrough[0] == "--":
        passthrough = passthrough[1:]

    spec = _load_yaml(args.config)
    metric_name = spec.get("metric", {}).get("name", "val_acc1")
    goal = spec.get("metric", {}).get("goal", "maximize")
    method = args.method or spec.get("method", "random")
    rng = random.Random(args.seed)

    from deltakd_tpu_torch.configs.config import parse_args as parse_train_args
    from deltakd_tpu_torch.train.loop import run

    best = None
    history: List[Tuple[Dict[str, Any], float]] = []
    for trial in range(args.trials):
        if method == "bayes":
            params = bayes_suggest(spec.get("parameters", {}), history, rng)
        else:
            params = sample_params(spec.get("parameters", {}), rng)
        # sweep params map to flags by replacing '_' with '-' (the reference
        # maps them through env vars in the recipe; same names either way)
        trial_argv = list(passthrough)
        for k, v in params.items():
            trial_argv += [f"--{k.replace('_', '-')}", str(v)]
        cfg = parse_train_args(trial_argv)
        cfg = cfg.replace(save_dir=f"{cfg.save_dir}/trial{trial}")
        print(f"[sweep] trial {trial}: {params}")
        metrics = run(cfg)
        score = metrics.get(metric_name, metrics.get("best_val_acc", 0.0))
        history.append((params, score if goal == "maximize" else -score))
        record = {"trial": trial, "params": params, "metrics": metrics,
                  metric_name: score}
        with open(args.output, "a") as f:
            f.write(json.dumps(record) + "\n")
        better = (best is None or
                  (score > best[0] if goal == "maximize" else score < best[0]))
        if better:
            best = (score, params)
        print(f"[sweep] trial {trial}: {metric_name}={score:.4f} "
              f"(best so far: {best[0]:.4f} {best[1]})")
    return best


if __name__ == "__main__":
    main()
