"""Hyperparameter search (JAX utils/tuner.py; reference
ultralytics/utils/tuner.py:6-120 run_ray_tune).

Sequential short trainings with an evolve loop: a few random warm-up
trials, then each candidate mutates a fitness-weighted elite (per-gene
mutation probability, a Gaussian step of a share of the bound's range,
clipped to the reference bounds). `strategy="random"` is plain random
search. The draws come from one `random.Random(seed)`, in the JAX tuner's
order, so a seed gives both packages the same candidates. Each trial's
config, fitness and metrics are returned, best first, and also written to
`results_file` (JSON) when one is named.
"""

from __future__ import annotations

import json
import random
from pathlib import Path

from . import LOGGER

DEFAULT_SPACE = {
    "lr0": (1e-5, 1e-1),
    "lrf": (0.01, 1.0),
    "momentum": (0.6, 0.98),
    "weight_decay": (0.0, 0.001),
    "warmup_epochs": (0.0, 5.0),
    "warmup_momentum": (0.0, 0.95),
    "box": (0.02, 0.2),
    "cls": (0.2, 4.0),
    "hsv_h": (0.0, 0.1),
    "hsv_s": (0.0, 0.9),
    "hsv_v": (0.0, 0.9),
    "translate": (0.0, 0.9),
    "scale": (0.0, 0.9),
    "fliplr": (0.0, 1.0),
    "mosaic": (0.0, 1.0),
    "lrl": (0.0, 5.0),   # the fork's recovery-loss weight
}

ELITES = 5          # parents are drawn from the top-k by fitness
MUT_PROB = 0.8      # per-gene mutation probability
MUT_SIGMA = 0.2     # Gaussian step, a share of the bound's range


def sample(space, rng):
    return {k: rng.uniform(*v) for k, v in space.items()}


def mutate(parent, space, rng):
    """Each gene moves by N(0, MUT_SIGMA * range) with probability
    MUT_PROB, clipped to its bounds; at least one gene moves."""
    child = dict(parent)
    keys = list(space)

    def step(k):
        lo, hi = space[k]
        child[k] = min(max(parent[k] + rng.gauss(0.0, MUT_SIGMA) * (hi - lo),
                           lo), hi)

    mutated = False
    for k in keys:
        if rng.random() < MUT_PROB:
            step(k)
            mutated = True
    if not mutated:
        step(rng.choice(keys))
    return child


def pick_parent(results, rng):
    """A fitness-weighted choice among the top elites; failed trials
    (fitness -1) never parent, and fitness 0 still does."""
    elites = sorted((r for r in results if r["fitness"] >= 0),
                    key=lambda r: -r["fitness"])[:ELITES]
    if not elites:
        return None
    weights = [r["fitness"] + 1e-6 for r in elites]
    return rng.choices(elites, weights=weights, k=1)[0]["cfg"]


def run_tune(model_yaml, data, space=None, trials=10, epochs_per_trial=5, seed=0,
             strategy="evolve", warmup_trials=3, results_file=None,
             **train_kwargs):
    """Tune hyperparameters; returns (best_cfg, results sorted by fitness).
    `model_yaml` is what `YOLO(model_yaml)` takes; `train_kwargs` go to every
    trial's `train`."""
    from ..engine.model import YOLO

    space = dict(space or DEFAULT_SPACE)
    rng = random.Random(seed)
    results = []
    for t in range(trials):
        cfg = None
        if strategy == "evolve" and t >= warmup_trials:
            parent = pick_parent(results, rng)
            if parent is not None:
                cfg = mutate(parent, space, rng)
        if cfg is None:
            cfg = sample(space, rng)
        LOGGER.info(f"tune trial {t + 1}/{trials}: "
                    + ", ".join(f"{k}={v:.4g}" for k, v in cfg.items()))
        try:
            metrics = YOLO(model_yaml, device=train_kwargs.get("device")).train(
                data=data, epochs=epochs_per_trial, name=f"tune{t}",
                exist_ok=True, **cfg, **train_kwargs)
            fitness = float(metrics.get("fitness", 0.0))
        except Exception as e:   # a bad config must not end the sweep
            LOGGER.info(f"trial {t} failed: {e}")
            fitness, metrics = -1.0, {}
        results.append({"trial": t, "fitness": fitness, "cfg": cfg,
                        "metrics": dict(metrics)})
    results.sort(key=lambda r: -r["fitness"])
    if results_file:
        Path(results_file).parent.mkdir(parents=True, exist_ok=True)
        Path(results_file).write_text(json.dumps(results, indent=1) + "\n")
    best = results[0]
    LOGGER.info(f"best trial {best['trial']}: fitness {best['fitness']:.4f}")
    return best["cfg"], results
