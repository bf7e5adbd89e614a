"""Named spans and a few counters inside the port's training step, active
only while a ``torch.profiler`` session records.

Off (no session): ``span`` reads one flag and returns a shared
``nullcontext``; nothing is made, hooked or counted.  On, a span

* opens a host event of the profiler's own trace
  (``torch._C._profiler._RecordFunctionFast``): no operator, so SAC's policy
  never sees it (``torch.profiler.record_function`` is dispatched as the
  operators ``profiler._record_function_enter_new`` / ``_exit``), and on the
  profiler's clock, so an idle gap of the device is named after the innermost
  span the host was in;
* times its host ms (``time.perf_counter``) and, in a step on a CUDA device,
  its **stream ms**: a pair of CUDA events on the current stream, from the
  stream reaching the span to leaving it; the span's kernels plus any idle of
  the device inside it, which is what the stage costs the step;
* is kept under its phase: ``fwd`` (the forward), ``rec`` (the forward run
  again inside the backward by activation checkpointing) or ``bwd``.

A stage (``STAGES``: the spans of the model's code) that is the outermost
stage of the forward also times its backward (``grads``): from the
first gradient of its outputs to the next stage's backward, or to the
gradient of its main input.  The autograd engine runs a device's nodes in
the reverse order of their creation, so the stages' backward intervals form
a chain.  A recompute pauses the backward stage it runs in, so that no time
is counted twice.

Each ``step`` span (``step``, in ``make_train_step``) appends a record to a
bounded list, ``steps()``: every span's count, host ms and stream ms by name
and phase, the operators SAC's policy judged (``policy_ops``; ``None``
without a SAC policy) and the kernel launches (``launches``).  The step adds
no synchronisation: stream ms are read when ``steps()`` is called.

The collector's passes are spans ``gc.gen<N>`` (a ``gc.callbacks`` entry
installed once), so that its pauses name the device's idle gaps too.

Names: ``step``, ``step.forward``, ``step.backward``, ``step.optimizer``,
``loss.head``, ``norm``, ``attn``, ``ssm.proj_in``, ``ssm.conv``,
``ssm.chunk``, ``ssm.scan``, ``ssm.gate``, ``ssm.proj_out``, ``moe.route``,
``moe.dispatch``, ``moe.experts``, ``moe.combine``, ``kernel.<entry
point>`` (``kernels.build.kernel_call``) and ``gc.gen<N>``.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import threading
import time

import torch
import torch.autograd.profiler as _profiler

#: what ``span`` returns while no session records
_OFF = contextlib.nullcontext()
#: the stages: spans of the model's code, whose backward is timed too
STAGES = frozenset({"loss.head", "norm", "attn", "ssm.proj_in", "ssm.conv", "ssm.chunk",
                    "ssm.scan", "ssm.gate", "ssm.proj_out", "moe.route", "moe.dispatch",
                    "moe.experts", "moe.combine"})
#: step records kept, the newest last: a record holds two CUDA events a span
#: until it is read, so few are kept (the benchmark reads two after a warm-up)
KEEP = 8
_STEPS: collections.deque = collections.deque(maxlen=KEEP)


def span(name: str, x=None):
    """A context manager: the span ``name`` (``x``: the stage's main input,
    whose gradient ends its backward; see ``grads``)."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, x)


def step(device):
    """The span ``step`` around one training step on ``device``; on, it
    appends the step's record to ``steps()``."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Step(torch.device(device))


def grads(sp, *outs) -> None:
    """Time the backward of the stage ``sp`` (what ``span`` gave) with
    outputs ``outs``: a no-op off, in a recompute or backward, inside another
    stage, or where no output requires grad."""
    if sp is None or sp.opened is None:
        return
    outs = [t for t in outs if isinstance(t, torch.Tensor) and t.requires_grad]
    if outs:
        name, rec, opened = sp.name, sp.rec, sp.opened
        torch.autograd.graph.register_multi_grad_hook(
            outs, lambda _: _open_bwd(name, rec, opened), mode="any")


def counted(policy):
    """``policy`` (a SAC policy), counting each operator it judges into the
    step's ``policy_ops`` while a step records; else ``policy`` itself."""
    rec = _STATE.record
    if rec is None:
        return policy
    if rec.policy_ops is None:
        rec.policy_ops = 0

    def count(ctx, op, *args, **kwargs):
        rec.policy_ops += 1
        return policy(ctx, op, *args, **kwargs)

    return count


def kernel(name: str, run):
    """``run`` inside the span ``kernel.<name>``."""
    def timed(*args):
        with _Span(f"kernel.{name}"):
            return run(*args)
    return timed


def steps() -> list[dict]:
    """The kept steps' records, oldest first (synchronises the device)."""
    return [r.summary() for r in list(_STEPS)]


# -- state -------------------------------------------------------------------------------


class _State:
    record: _Record | None = None     # the step being recorded
    bwd: _Bwd | None = None           # the backward stage span now open
    task: int = -1                    # the graph task whose end closes ``bwd``
    gc: _Pass | None = None           # the collector's pass now running


class _Thread(threading.local):
    """Per thread (the backward runs on the autograd engine's): the spans of
    code open, innermost last."""

    def __init__(self):
        self.stack: list = []


_STATE = _State()
_THREAD = _Thread()


def _phase(outer) -> str:
    """``fwd`` outside a backward; inside one, the phase of the enclosing
    span of the backward, else ``rec`` under grad mode (the recompute) and
    ``bwd`` without (a backward function)."""
    if torch._C._current_graph_task_id() == -1:
        return "fwd"
    if outer is not None and outer.phase != "fwd":
        return outer.phase
    return "rec" if torch.is_grad_enabled() else "bwd"


def _launches() -> int:
    from ..kernels import build
    return sum(build.LAUNCHES.values())


class _Record:
    """One step: each span's entry ``(name, phase, top, segments)``, a
    segment ``(host_t0, host_t1, event_0, event_1)`` (events ``None`` off
    CUDA)."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.device = device
        self.start = _event() if self.cuda else None
        self.t0 = time.perf_counter()
        self.entries: list = []
        self.policy_ops: int | None = None
        self.launches0 = _launches()
        self.launches: int | None = None
        self._summary: dict | None = None

    def summary(self) -> dict:
        if self._summary is not None:
            return self._summary
        if self.cuda:
            torch.cuda.synchronize(self.device)
        spans: dict = {}
        intervals = []
        for name, phase, top, segs in self.entries:
            rows = [((h0 - self.t0) * 1e3, (h1 - self.t0) * 1e3,
                     self.start.elapsed_time(e0) if e0 is not None else None,
                     self.start.elapsed_time(e1) if e1 is not None else None)
                    for h0, h1, e0, e1 in segs]
            host = sum(r[1] - r[0] for r in rows)
            stream = None if rows[0][2] is None else sum(r[3] - r[2] for r in rows)
            zero = None if stream is None else 0.0
            d = spans.setdefault(name, {}).setdefault(phase, {
                "count": 0, "host_ms": 0.0, "stream_ms": zero,
                "top_host_ms": 0.0, "top_stream_ms": zero})
            d["count"] += 1
            d["host_ms"] += host
            if stream is not None:
                d["stream_ms"] += stream
            if top:
                d["top_host_ms"] += host
                if stream is not None:
                    d["top_stream_ms"] += stream
            intervals.append([name, phase, top, [list(r) for r in rows]])
        self._summary = {"spans": spans, "policy_ops": self.policy_ops,
                         "launches": self.launches, "intervals": intervals}
        self.entries = []
        return self._summary


def _event():
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


class _Span:
    """A span of code (``span``, ``kernel``)."""

    def __init__(self, name: str, x=None):
        self.name, self.x = name, x
        self.opened: list | None = None     # the backward spans ``grads`` opened

    def __enter__(self):
        stack = _THREAD.stack
        outer = stack[-1] if stack else None
        self.phase = _phase(outer)
        inside = outer is not None and outer.phase == self.phase and outer.in_stage
        stage = self.name in STAGES
        self.top, self.in_stage = stage and not inside, stage or inside
        self.rec = rec = _STATE.record
        self.paused = None
        if self.top and self.phase == "rec" and _STATE.bwd is not None:
            self.paused = _STATE.bwd
            self.paused.pause()
        x, self.x = self.x, None
        if self.top and self.phase == "fwd":
            opened = self.opened = []
            if isinstance(x, torch.Tensor) and x.requires_grad:
                x.register_hook(lambda _: _close_bwd(opened))
        stack.append(self)
        self.rf = torch._C._profiler._RecordFunctionFast(self.name)
        self.rf.__enter__()
        self.e0 = _event() if rec is not None and rec.cuda else None
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        e1 = _event() if self.e0 is not None else None
        self.rf.__exit__(None, None, None)
        _THREAD.stack.pop()
        if self.rec is not None:
            self.rec.entries.append((self.name, self.phase, self.top,
                                     ((self.t0, t1, self.e0, e1),)))
        if self.paused is not None:
            self.paused.resume()
        return False


class _Step(_Span):
    def __init__(self, device):
        super().__init__("step")
        self.device = device

    def __enter__(self):
        self.outer_record = _STATE.record
        _STATE.record = _Record(self.device)
        return super().__enter__()

    def __exit__(self, *exc):
        super().__exit__(*exc)
        rec = self.rec
        rec.launches = _launches() - rec.launches0
        _STATE.record = self.outer_record
        _STEPS.append(rec)
        return False


class _Bwd:
    """A stage's backward: opened by its outputs' first gradient, closed by
    the next stage's opening or by its main input's gradient.  A recompute
    inside it pauses its clocks; its host event stays open."""

    def __init__(self, name: str, rec: _Record | None):
        self.name, self.rec = name, rec
        self.rf = torch._C._profiler._RecordFunctionFast(name)
        self.rf.__enter__()
        self.segs: list = []
        self.start: tuple | None = None
        self.resume()

    def resume(self) -> None:
        if self.start is None:
            e0 = _event() if self.rec is not None and self.rec.cuda else None
            self.start = (time.perf_counter(), e0)

    def pause(self) -> None:
        if self.start is not None:
            t0, e0 = self.start
            t1 = time.perf_counter()
            self.segs.append((t0, t1, e0, _event() if e0 is not None else None))
            self.start = None

    def close(self) -> None:
        self.pause()
        self.rf.__exit__(None, None, None)
        if self.rec is not None and self.segs:
            self.rec.entries.append((self.name, "bwd", True, tuple(self.segs)))


def _open_bwd(name: str, rec: _Record | None, opened: list) -> None:
    task = torch._C._current_graph_task_id()
    if _STATE.task != task:
        _STATE.task = task
        torch.autograd.Variable._execution_engine.queue_callback(_end_bwd)
    _end_bwd()
    _STATE.bwd = _Bwd(name, rec)
    opened.append(_STATE.bwd)


def _close_bwd(opened: list) -> None:
    if opened and _STATE.bwd is opened[-1]:
        _end_bwd()


def _end_bwd() -> None:
    if _STATE.bwd is not None:
        _STATE.bwd.close()
        _STATE.bwd = None


class _Pass:
    """One pass of the collector: host time only (the device runs on)."""

    def __init__(self, generation: int):
        self.name = f"gc.gen{generation}"
        self.rec, self.phase = _STATE.record, _phase(None)
        self.rf = torch._C._profiler._RecordFunctionFast(self.name)
        self.rf.__enter__()
        self.t0 = time.perf_counter()

    def close(self) -> None:
        t1 = time.perf_counter()
        self.rf.__exit__(None, None, None)
        if self.rec is not None:
            self.rec.entries.append((self.name, self.phase, False,
                                     ((self.t0, t1, None, None),)))


def _collector(phase: str, info: dict) -> None:
    """The ``gc.callbacks`` entry: a span ``gc.gen<N>`` over each pass of the
    collector while a session records."""
    if phase == "start":
        if _profiler._is_profiler_enabled:
            _STATE.gc = _Pass(info["generation"])
    elif _STATE.gc is not None:
        _STATE.gc.close()
        _STATE.gc = None


if _collector not in gc.callbacks:
    gc.callbacks.append(_collector)
