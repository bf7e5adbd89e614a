"""One run of one cell of the port's benchmark: set-up, the measured window,
the traced steps and the comparison with the plain reference.

Everything a cell is made of is found by the names ``BENCHMARK.json`` gives:
the configuration's file, the job mix ``traffic/<mix>.json``, the limits of
the comparison ``limits/<workload>.json``, the model family's reference
``reference/<family>.py``, each mixer's FLOP term ``flops/<mixer>.py``, each
kernel operation's bound and name patterns ``kernels/<op>.py`` and each
per-layer metric's reader ``metrics/<metric>.py``, all under the folder
``portbench`` of the root that holds ``BENCHMARK.json``.

A run (``run``):

1. set-up: the port's ``Trainer`` for the configuration under the mix's
   remat policy and optimizer; its parameters made on the device from the
   seed, leaf by leaf, by the reference's leaf list, and checked against the
   tree ``init_params`` lays out (read on ``meta``); the AdamW state from
   ``Trainer.opt.init``; a pool of token batches from the seed;
2. the first ``CHECK_STEPS`` steps through ``Trainer.step_fn``, as the window
   calls it, on rows that all differ; they warm every shape up and give the
   readings the comparison needs (each step's loss, each leaf's first
   gradient from the AdamW moment, each leaf's change after the last);
3. the window: ``step_fn`` once a step, its metrics read to the host after
   each, as ``Trainer.fit`` does, until ``seconds`` have passed;
4. with ``trace``, ``PROFILE_STEPS`` more steps under ``torch.profiler``;
5. the program's state freed, the reference's ``CHECK_STEPS`` steps in fp32
   from the same weights and batches, and the comparison.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import statistics
import subprocess
import sys
import time
from functools import cache
from pathlib import Path

import numpy as np

from portbench import check, modelflops
from portbench.devtrace import Trace
from portbench.reference import common

BASE = Path(__file__).resolve().parent
ROOT = BASE.parent
#: top-level module names no run may hold: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: steps the comparison reads, taken in set-up; steps a traced run records;
#: batches of the token pool the window cycles through (the same in every job)
CHECK_STEPS, PROFILE_STEPS, POOL = 3, 2, 48


# -- finding a cell's pieces -----------------------------------------------------


@cache
def load_module(path: str):
    """A plug-in module (a reference, a FLOP term, a kernel's bound, a
    metric's reader) from its file."""
    p = Path(path)
    spec = importlib.util.spec_from_file_location(
        f"portbench_plugin.{p.parent.name}.{p.stem}", p)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    config: dict            # the configuration's file
    job: dict               # the job mix
    limits: dict            # the compared numbers' limits
    metrics: dict           # per-layer metric name → unit
    chips: int
    base: Path = BASE

    @property
    def model(self) -> dict:
        return self.config["model"]

    def family(self):
        return load_module(str(self.base / "reference" / f"{self.model['family']}.py"))

    def mixer(self, name: str):
        return load_module(str(self.base / "flops" / f"{name}.py"))

    def ops(self) -> dict:
        """Every kernel operation's module, by name."""
        return {p.stem: load_module(str(p)) for p in sorted((self.base / "kernels").glob("*.py"))
                if p.stem != "__init__"}

    def reader(self, metric: str):
        return load_module(str(self.base / "metrics" / f"{metric}.py"))

    def step_flops(self) -> float:
        return modelflops.step_flops(self.model, self.job, self.family(), self.mixer)


def resolve(workload: str, root: Path = ROOT) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json``, its files read from
    ``root/portbench``."""
    base = root / "portbench"
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: {sorted(cells)}")
    w = cells[workload]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    metrics = {m["name"]: m["unit"] for m in bench["per_layer"]
               if workload in m.get("workloads", [workload])}
    return Cell(name=workload,
                config=json.loads((root / cfg["file"]).read_text()),
                job=json.loads((base / "traffic" / f"{w['traffic']}.json").read_text()),
                limits=json.loads((base / "limits" / f"{workload}.json").read_text())["limits"],
                metrics=metrics, chips=w["chips"], base=base)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


# -- inputs made from the seed ------------------------------------------------------


def _mix(seed: int, index: int) -> int:
    return (seed * 0x9E3779B97F4A7C15 + index * 0xBF58476D1CE4E5B9 + 1) % (1 << 63)


def make_leaf(spec, seed: int, index: int, device):
    """One parameter, drawn on ``device`` in its own dtype from a generator
    of its own (so any leaf can be drawn again alone)."""
    import torch

    shape, dtype, init, _ = spec
    dt = getattr(torch, dtype)
    if init == "zeros":
        return torch.zeros(shape, dtype=dt, device=device)
    if init == "ones":
        return torch.ones(shape, dtype=dt, device=device)
    gen = torch.Generator(device=device).manual_seed(_mix(seed, index))
    if init in ("a_log", "dt_bias"):
        # Mamba-2's published draws: A = −U[1, 16]; dt log-uniform on
        # [1e-3, 0.1] (at least 1e-4), held as softplus⁻¹(dt)
        u = torch.rand(shape, generator=gen, dtype=torch.float32, device=device)
        if init == "a_log":
            return torch.log1p(15 * u).to(dt)
        lo, hi = math.log(1e-3), math.log(0.1)
        step = torch.exp(lo + (hi - lo) * u).clamp_min(1e-4)
        return (step + torch.log(-torch.expm1(-step))).to(dt)
    std = 0.02 if init == "small" else 1.0 / math.sqrt(shape[-2] if len(shape) > 1 else shape[-1])
    return torch.randn(shape, generator=gen, dtype=dt, device=device).mul_(std)


#: entries of a leaf whose first gradient the comparison reads one by one (a
#: leaf with no more is read whole)
SAMPLE = 1 << 16


def sample_index(shape, seed: int, index: int, device):
    """The entries of a leaf the comparison reads one by one: ``SAMPLE`` flat
    indices drawn from the seed on ``device``, or ``None`` for all of them."""
    import torch

    n = math.prod(shape)
    if n <= SAMPLE:
        return None
    gen = torch.Generator(device=device).manual_seed(_mix(seed, index + (1 << 20)))
    return torch.randint(0, n, (SAMPLE,), generator=gen, device=device)


def leaf_sizes(cell) -> dict:
    """Each parameter's number of entries, by path."""
    return {p: math.prod(s[0]) for p, s in cell.family().leaves(cell.model).items()}


def take(t, idx):
    """The entries ``idx`` of ``t`` (all for ``None``), in fp32 on the host."""
    t = t.detach().reshape(-1)
    return (t if idx is None else t[idx]).float().cpu()


def philox_u32(ctr: np.ndarray, key: int) -> np.ndarray:
    """Counter-based hash (xorshift-multiply), the same on every host: a copy
    of the port's data pipeline's generator."""
    salt = np.uint64((key * 0x9E3779B97F4A7C15) % (1 << 64))
    with np.errstate(over="ignore"):
        x = ctr.astype(np.uint64) + salt
        x ^= x >> np.uint64(33)
        x *= np.uint64(0xFF51AFD7ED558CCD)
        x ^= x >> np.uint64(33)
        x *= np.uint64(0xC4CEB9FE1A85EC53)
        x ^= x >> np.uint64(33)
    return (x & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def token_pool(job: dict, vocab: int, seed: int) -> np.ndarray:
    """``POOL`` batches of ``batch`` rows of ``seq + 1`` uniform token ids:
    inputs are a row's first ``seq``, labels its last ``seq`` (next token)."""
    P, B, S = POOL, job["batch"], job["seq"]
    toks = philox_u32(np.arange(P * B * (S + 1), dtype=np.uint64), seed + 1) % np.uint32(vocab)
    return toks.reshape(P, B, S + 1).astype(np.int32)


def flat(tree, prefix="") -> dict:
    """A nested dict's leaves by '/'-joined path."""
    if not isinstance(tree, dict):
        return {prefix[:-1]: tree}
    out = {}
    for k in sorted(tree):
        out.update(flat(tree[k], f"{prefix}{k}/"))
    return out


def params_like(tree, make, prefix=""):
    """``tree``'s structure with each leaf at path ``p`` replaced by ``make(p)``."""
    if not isinstance(tree, dict):
        return make(prefix[:-1])
    return {k: params_like(v, make, f"{prefix}{k}/") for k, v in tree.items()}


# -- the program ----------------------------------------------------------------


def port_config(cell: Cell):
    """The port's ``ModelConfig`` as the configuration's file states it, under
    the mix's remat policy."""
    from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig, SSMConfig

    m = dict(cell.model)
    for key, cls in (("ssm", SSMConfig), ("moe", MoEConfig), ("mla", MLAConfig)):
        if m.get(key) is not None:
            m[key] = cls(**m[key])
    m["pattern"] = tuple(m["pattern"])
    return ModelConfig(name=cell.config["arch"], remat=cell.job["remat"], **m)


class Program:
    """The system under test: a ``Trainer``'s step, its parameters, its
    optimizer state and the token pool, on one device."""

    def __init__(self, cell: Cell, seed: int, device: str):
        import torch
        from repro_torch.configs.base import ShapeConfig
        from repro_torch.launch.train import Trainer
        from repro_torch.models.transformer import abstract_params

        job = cell.job
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.cfg = port_config(cell)
        shape = ShapeConfig("portbench", job["seq"], job["batch"], "train")
        self.trainer = Trainer(self.cfg, shape, optimizer=job["optimizer"], lr=job["lr"],
                               seed=seed, device=device)
        self.leaves = cell.family().leaves(cell.model)
        self.order = {p: i for i, p in enumerate(sorted(self.leaves))}
        meta = abstract_params(self.cfg)
        got = {p: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
               for p, t in flat(meta).items()}
        want = {p: (tuple(s[0]), s[1]) for p, s in self.leaves.items()}
        if got != want:
            raise RuntimeError(f"the reference's leaves {want} are not the port's tree {got}")
        self.params = params_like(meta, self.initial)
        self.opt_state = self.trainer.opt.init(self.params)
        pool = torch.from_numpy(token_pool(job, cell.model["vocab"], seed)).to(self.device)
        self.inputs = pool[:, :, :-1].contiguous()
        self.labels = pool[:, :, 1:].contiguous()

    def initial(self, path: str):
        return make_leaf(self.leaves[path], self.seed, self.order[path], self.device)

    def sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def step(self, i: int) -> tuple[dict, float]:
        """Step ``i`` on batch ``i`` of the pool (cycled): (its metrics,
        host seconds until ``step_fn`` returned)."""
        b = i % self.inputs.shape[0]
        batch = {"inputs": self.inputs[b], "labels": self.labels[b]}
        t0 = time.perf_counter()
        self.params, self.opt_state, metrics = self.trainer.step_fn(
            self.params, self.opt_state, batch, i)
        issued = time.perf_counter() - t0
        vals = {k: float(v) for k, v in metrics.items()}
        self.sync()
        return vals, issued

    def sample(self, path: str):
        return sample_index(self.leaves[path][0], self.seed, self.order[path], self.device)

    def readings(self) -> dict:
        """The first ``CHECK_STEPS`` steps, with what the comparison reads:
        each step's loss; each leaf's first gradient (from the AdamW moment
        m = (1 − b1)·g after the first step), its norm and sampled entries;
        each leaf's norm of change after the last step."""
        import torch

        b1 = common.ADAMW["b1"]
        losses, grads, g_at = [], {}, {}
        self.check_s = []
        for i in range(CHECK_STEPS):
            t0 = time.perf_counter()
            losses.append(self.step(i)[0]["loss"])
            self.check_s.append(time.perf_counter() - t0)
            if i == 0:
                for p, m in flat(self.opt_state["m"]).items():
                    grads[p] = float(torch.linalg.vector_norm(m.float())) / (1 - b1)
                    g_at[p] = take(m, self.sample(p)) / (1 - b1)
        change = {p: float(torch.linalg.vector_norm(t.detach().float() - self.initial(p).float()))
                  for p, t in flat(self.params).items()}
        return {"losses": losses, "grad_norms": grads, "update_norms": change,
                "grad_samples": g_at}


def reference_readings(cell: Cell, seed: int, device: str, prec: str = "fp32",
                       rows: slice | None = None) -> dict:
    """The reference's ``CHECK_STEPS`` steps from the weights and batches the
    program had (``rows``: the batch rows it is given, all by default)."""
    import torch

    family, job = cell.family(), cell.job
    leaves = family.leaves(cell.model)
    order = {p: i for i, p in enumerate(sorted(leaves))}
    dev = torch.device(device)

    def initial(p):
        return make_leaf(leaves[p], seed, order[p], dev)

    params = {p: initial(p).float() for p in sorted(leaves)}
    pool = torch.from_numpy(token_pool(job, cell.model["vocab"], seed)[:CHECK_STEPS])
    pool = pool.to(dev).long()[:, rows or slice(None)]

    def batches(i):
        return pool[i, :, :-1], pool[i, :, 1:]

    def sample(p):
        return sample_index(leaves[p][0], seed, order[p], dev)

    return common.train(family, cell.model, job, params, batches, CHECK_STEPS, prec,
                        initial, sample, take)


# -- the run --------------------------------------------------------------------------


@dataclasses.dataclass
class Context:
    """What a per-layer metric's reader reads."""
    cell: Cell
    device_type: str
    window: dict            # steps, seconds, issue_s (a list, one a step)
    trace: Trace | None     # the profiled steps (trace runs on the card)

    def kernel_bounds(self) -> dict[str, float]:
        """Each kernel operation's bound, ms a step."""
        from portbench import roofline as rf

        family = self.cell.family()
        return {op: sum(n * rf.bound_ms(f, b, peak) for n, f, b, peak
                        in mod.work(self.cell.model, self.cell.job, family))
                for op, mod in self.cell.ops().items()}


class GcClock:
    """A ``gc.callbacks`` entry: the count and the host seconds of the
    collector's passes by generation (what pauses a host-bound step)."""

    def __init__(self):
        self.started, self.count, self.seconds = 0.0, [0, 0, 0], [0.0, 0.0, 0.0]

    def __call__(self, phase, info):
        if phase == "start":
            self.started = time.perf_counter()
        else:
            self.count[info["generation"]] += 1
            self.seconds[info["generation"]] += time.perf_counter() - self.started

    def summary(self) -> dict:
        return {"count": self.count, "seconds": [round(x, 4) for x in self.seconds]}


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not read"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "not read"


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
        t_start: float | None = None) -> tuple[dict, list[str]]:
    """One run; returns (the result line's object, the lines for standard
    error: what the run noted, then each compared number beside its limit)."""
    import torch

    t_entry = time.perf_counter()
    t_start = t_entry if t_start is None else t_start
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    prog = Program(cell, seed, device)
    t_program = time.perf_counter()
    readings = prog.readings()
    prog.sync()
    setup_s = time.perf_counter() - t_start
    # set-up by phase: imports, the program's state, each checked step
    phases = {"imports_s": t_entry - t_start, "program_s": t_program - t_entry,
              "check_steps_s": [round(x, 4) for x in prog.check_s]}

    i = CHECK_STEPS
    issue, losses, ends = [], [], []
    collections = GcClock()
    gc.callbacks.append(collections)
    t0 = time.perf_counter()
    while True:
        vals, issued = prog.step(i)
        ends.append(time.perf_counter() - t0)
        issue.append(issued)
        losses.append(vals["loss"])
        i += 1
        if ends[-1] >= seconds:
            break
    window_s = ends[-1]
    gc.callbacks.remove(collections)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    window = {"steps": len(issue), "seconds": window_s, "issue_s": issue}

    traced = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        # a step under a first profiler, whose record is dropped, so that the
        # profiler's start-up stays out of the steps the second one records
        n = PROFILE_STEPS
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        for steps in (1, n):
            with profile(activities=acts) as prof:
                tp = time.perf_counter()
                for _ in range(steps):
                    prog.step(i)
                    i += 1
                wall = time.perf_counter() - tp
        traced = Trace.of(prof, n, wall)
        del prof

    del prog
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = reference_readings(cell, seed, device)
    reference_s = time.perf_counter() - t_ref
    gaps, worst = check.gaps(readings, ref, leaf_sizes(cell))
    failed = sum(not math.isfinite(x) for x in losses)
    correct = failed == 0 and check.passes(gaps, cell.limits)

    tokens = len(issue) * cell.job["batch"] * cell.job["seq"]
    if trace:
        ctx = Context(cell, torch.device(device).type, window, traced)
        metrics = {}
        for name, unit in cell.metrics.items():
            value = cell.reader(name).read(ctx)
            if value is not None:
                metrics[name] = {"value": value, "unit": unit}
    else:
        metrics = {"train_tokens_per_s": {"value": tokens / window_s, "unit": "tokens/s"},
                   "peak_mem_gb": {"value": peak / 1e9, "unit": "GB"},
                   "setup_s": {"value": setup_s, "unit": "s"}}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": len(issue), "failed": failed,
              "metrics": metrics, "device": dev}
    if traced is not None and traced.device:
        dev["busy_s"] = traced.busy_s()
        dev["window_s"] = traced.wall_s
        result["breakdown"] = {"device_ops": traced.top_ops(), "idle_gaps": traced.idle_gaps()}
    result["checks"] = {k: {"value": gaps[k], "limit": lim} for k, lim in cell.limits.items()}
    notes = {"card": power_limit() if cuda else "cpu", "setup_s": setup_s,
             "setup": phases, "reference_s": reference_s, "steps": len(issue), "window_s": window_s,
             "step_s": [round(b - a, 4) for a, b in zip([0.0, *ends], ends)],
             "gc_in_window": collections.summary(),
             "losses": [losses[0], statistics.median(losses), losses[-1]], "worst_leaves": worst,
             "not_compared": {k: v for k, v in gaps.items() if k not in cell.limits}}
    lines = [f"portbench: {json.dumps(notes)}"]
    lines += [f"check {k} {gaps[k]!r} limit {lim!r}" for k, lim in cell.limits.items()]
    return result, lines
