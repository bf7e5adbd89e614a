"""Clean-room NSGA-II (Deb et al., 2002) for multi-objective search.

Two genome representations share the elitist (μ+λ) survival machinery:
``nsga2`` over bitmasks (the activation-checkpointing optimizer, paper
§V-B) and ``nsga2_int`` over bounded integer vectors (the parallel-training
strategy search, ``repro.core.parallel.ga_parallel``).  Validated on ZDT1
in the tests.

The port's own copy of ``repro.core.nsga2`` (numpy and plain Python):
names, signatures and numeric code are the reference's, held bit for
bit against it by ``tests/test_torch_search.py``.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass

import numpy as np

SNAPSHOT_FORMAT = "nsga2-snapshot-v1"


def fast_non_dominated_sort(F: np.ndarray) -> list[np.ndarray]:
    """F: (n, m) objective matrix (minimize).  Returns fronts as index arrays.

    One vectorized pairwise domination matrix feeds both the dominated-by
    relation and the domination counts (the former per-row scan computed the
    same relation twice), and front peeling is pure array arithmetic."""
    # dom[i, j]  <=>  i dominates j: all(F_i <= F_j) and any(F_i < F_j)
    le = np.all(F[:, None, :] <= F[None, :, :], axis=2)
    lt = np.any(F[:, None, :] < F[None, :, :], axis=2)
    dom = le & lt
    np.fill_diagonal(dom, False)
    dom_count = dom.sum(axis=0)
    fronts: list[np.ndarray] = []
    current = np.nonzero(dom_count == 0)[0]
    while current.size:
        fronts.append(current)
        dom_count = dom_count - dom[current].sum(axis=0)
        dom_count[current] = -1          # processed: never reaches zero again
        current = np.nonzero(dom_count == 0)[0]
    return fronts


def crowding_distance(F: np.ndarray) -> np.ndarray:
    n, m = F.shape
    d = np.zeros(n)
    if n <= 2:
        return np.full(n, np.inf)
    for k in range(m):
        order = np.argsort(F[:, k], kind="stable")
        fmin, fmax = F[order[0], k], F[order[-1], k]
        d[order[0]] = d[order[-1]] = np.inf
        span = max(fmax - fmin, 1e-30)
        d[order[1:-1]] += (F[order[2:], k] - F[order[:-2], k]) / span
    return d


@dataclass
class NSGA2Result:
    X: np.ndarray          # (pop, n_var) final population genomes
    F: np.ndarray          # (pop, n_obj) objectives
    pareto_X: np.ndarray
    pareto_F: np.ndarray
    history: list          # best-front hypervolume proxy per generation
    generations_run: int = 0   # generations completed (resumed runs include
    #                            the pre-crash ones; < requested when a
    #                            wall-clock / eval budget stopped the search)
    n_evals: int = 0           # evaluate() calls made by *this* run


def save_snapshot(path: str, state: dict) -> None:
    """Atomically persist a search snapshot (write-temp + rename) so a crash
    mid-write can never leave a truncated file behind."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(state, f)
    os.replace(tmp, path)


def load_snapshot(path: str) -> dict:
    with open(path) as f:
        state = json.load(f)
    if state.get("format") != SNAPSHOT_FORMAT:
        raise ValueError(f"unrecognized snapshot format in {path!r}: "
                         f"{state.get('format')!r}")
    return state


def _snapshot_state(X, F, rng, generation, history) -> dict:
    """Everything needed to continue bit-for-bit: population, objectives,
    per-generation history, and the PCG64 bit-generator state.  All values
    are ints / floats, so JSON round-trips them exactly."""
    return {
        "format": SNAPSHOT_FORMAT,
        "generation": int(generation),
        "dtype": "bool" if X.dtype == np.bool_ else "int",
        "X": X.tolist(),
        "F": F.tolist(),
        "history": [float(h) for h in history],
        "rng_state": rng.bit_generator.state,
    }


def _rank_and_crowd(Fm: np.ndarray):
    fronts = fast_non_dominated_sort(Fm)
    rank = np.empty(Fm.shape[0], dtype=int)
    crowd = np.empty(Fm.shape[0])
    for r, fr in enumerate(fronts):
        rank[fr] = r
        crowd[fr] = crowding_distance(Fm[fr])
    return rank, crowd, fronts


def _evolve(evaluate, X: np.ndarray, rng, generations: int,
            p_crossover: float, crossover, mutate,
            snapshot_every: int = 0, snapshot_path: str | None = None,
            resume: dict | str | None = None,
            max_seconds: float | None = None,
            max_evals: int | None = None,
            evaluate_batch=None) -> NSGA2Result:
    """Shared NSGA-II core: binary-tournament selection, elitist (μ+λ)
    survival with crowding truncation, and Pareto-front dedup.  The genome
    representation lives entirely in the ``crossover(a, b)`` / ``mutate(c)``
    operators (both mutate in place, drawing from ``rng``).

    ``snapshot_every=k`` persists a crash-resume snapshot to
    ``snapshot_path`` every k generations; ``resume`` (a snapshot dict or a
    path to one) restores population + RNG state and continues the exact
    run — the resumed front is bit-for-bit identical to the uninterrupted
    one.  ``max_seconds`` / ``max_evals`` stop early and return the
    best-so-far front; neither consumes RNG draws, so enabling them never
    perturbs the search trajectory.

    ``evaluate_batch(X) -> list of objective tuples`` scores a whole
    population in one call (engine ``score_batch`` path, docs/engine.md);
    it must agree with ``evaluate`` bit-for-bit and consumes no RNG, so
    toggling it never changes the trajectory."""
    t0 = time.monotonic()
    n_evals = 0

    def eval_pop(P: np.ndarray) -> np.ndarray:
        if evaluate_batch is not None:
            return np.array(evaluate_batch(P), dtype=float)
        return np.array([evaluate(x) for x in P], dtype=float)

    if resume is not None:
        state = load_snapshot(resume) if isinstance(resume, str) else resume
        dtype = np.bool_ if state["dtype"] == "bool" else int
        X = np.array(state["X"], dtype=dtype)
        F = np.array(state["F"], dtype=float)
        history = [float(h) for h in state["history"]]
        start_gen = int(state["generation"])
        rng.bit_generator.state = state["rng_state"]
    else:
        F = eval_pop(X)
        n_evals = X.shape[0]
        history = []
        start_gen = 0
    pop_size, n_var = X.shape
    rank, crowd, _ = _rank_and_crowd(F)

    for gen in range(start_gen, generations):
        if max_seconds is not None and time.monotonic() - t0 >= max_seconds:
            break                                   # budget: best-so-far
        if max_evals is not None and n_evals + pop_size > max_evals:
            break
        def pick():
            i, j = rng.integers(0, pop_size, 2)
            if (rank[i], -crowd[i]) <= (rank[j], -crowd[j]):
                return i
            return j

        children = []
        while len(children) < pop_size:
            a, b = X[pick()].copy(), X[pick()].copy()
            if rng.random() < p_crossover and n_var > 1:
                crossover(a, b)
            for c in (a, b):
                mutate(c)
                children.append(c)
        C = np.array(children[:pop_size])
        CF = eval_pop(C)
        n_evals += pop_size

        # elitist (μ+λ) survival
        XA = np.concatenate([X, C])
        FA = np.concatenate([F, CF])
        r2, c2, fronts = _rank_and_crowd(FA)
        chosen: list[int] = []
        for fr in fronts:
            if len(chosen) + len(fr) <= pop_size:
                chosen.extend(fr.tolist())
            else:
                rem = pop_size - len(chosen)
                order = fr[np.argsort(-c2[fr])]
                chosen.extend(order[:rem].tolist())
                break
        idx = np.array(chosen)
        X, F = XA[idx], FA[idx]
        rank, crowd, _ = _rank_and_crowd(F)
        history.append(float(F[rank == 0].mean()))
        if snapshot_every and (gen + 1) % snapshot_every == 0:
            save_snapshot(snapshot_path or os.path.join(
                "artifacts", "nsga2_snapshot.json"),
                _snapshot_state(X, F, rng, gen + 1, history))

    fronts = fast_non_dominated_sort(F)
    pf = fronts[0]
    # dedupe identical objective rows on the front
    _, uniq = np.unique(F[pf].round(9), axis=0, return_index=True)
    pf = pf[np.sort(uniq)]
    return NSGA2Result(X, F, X[pf], F[pf], history,
                       generations_run=len(history), n_evals=n_evals)


def nsga2(evaluate, n_var: int, pop_size: int = 32, generations: int = 25,
          seed: int = 0, p_crossover: float = 0.9,
          p_mutation: float | None = None, init: np.ndarray | None = None,
          snapshot_every: int = 0, snapshot_path: str | None = None,
          resume: dict | str | None = None, max_seconds: float | None = None,
          max_evals: int | None = None, evaluate_batch=None) -> NSGA2Result:
    """``evaluate(mask: np.ndarray[bool]) -> tuple`` of objectives (minimize)."""
    rng = np.random.default_rng(seed)
    p_mut = p_mutation if p_mutation is not None else 1.0 / max(n_var, 1)

    X = rng.random((pop_size, n_var)) < 0.5
    if init is not None:
        k = min(len(init), pop_size)
        X[:k] = init[:k]
    X[0] = True   # always seed the all-keep (baseline) individual

    def crossover(a, b):                 # one-point tail swap
        cut = rng.integers(1, n_var)
        a[cut:], b[cut:] = b[cut:].copy(), a[cut:].copy()

    def mutate(c):                       # independent bit flips
        flip = rng.random(n_var) < p_mut
        c[flip] = ~c[flip]

    return _evolve(evaluate, X, rng, generations, p_crossover,
                   crossover, mutate, snapshot_every=snapshot_every,
                   snapshot_path=snapshot_path, resume=resume,
                   max_seconds=max_seconds, max_evals=max_evals,
                   evaluate_batch=evaluate_batch)


def nsga2_int(evaluate, bounds: list, pop_size: int = 16,
              generations: int = 10, seed: int = 0,
              p_crossover: float = 0.9, p_mutation: float | None = None,
              init: np.ndarray | None = None,
              snapshot_every: int = 0, snapshot_path: str | None = None,
              resume: dict | str | None = None,
              max_seconds: float | None = None,
              max_evals: int | None = None,
              evaluate_batch=None) -> NSGA2Result:
    """Integer-genome NSGA-II for categorical/mixed search spaces (chip count
    × parallelism strategy × checkpointing budget — see
    ``repro.core.parallel.ga_parallel`` — and the ternary activation-policy
    genome of ``checkpointing.ga_policy``).

    ``bounds``: per-gene ``(lo, hi)`` inclusive ranges.
    ``evaluate(genome: np.ndarray[int]) -> tuple`` of objectives (minimize).
    Uniform crossover + per-gene uniform-resample mutation.  ``init``
    optionally seeds the first rows of the population (e.g. the all-KEEP /
    all-RECOMPUTE / all-OFFLOAD corner policies)."""
    rng = np.random.default_rng(seed)
    n_var = len(bounds)
    lo = np.array([b[0] for b in bounds], dtype=int)
    hi = np.array([b[1] for b in bounds], dtype=int)
    p_mut = p_mutation if p_mutation is not None else 1.0 / max(n_var, 1)

    X = rng.integers(lo, hi + 1, size=(pop_size, n_var))
    if init is not None:
        seeds = np.clip(np.asarray(init, dtype=int), lo, hi)
        k = min(len(seeds), pop_size)
        X[:k] = seeds[:k]

    def crossover(a, b):                 # uniform gene swap
        swap = rng.random(n_var) < 0.5
        a[swap], b[swap] = b[swap].copy(), a[swap].copy()

    def mutate(c):                       # uniform resample within bounds
        flip = rng.random(n_var) < p_mut
        if flip.any():
            c[flip] = rng.integers(lo[flip], hi[flip] + 1)

    return _evolve(evaluate, X, rng, generations, p_crossover,
                   crossover, mutate, snapshot_every=snapshot_every,
                   snapshot_path=snapshot_path, resume=resume,
                   max_seconds=max_seconds, max_evals=max_evals,
                   evaluate_batch=evaluate_batch)
