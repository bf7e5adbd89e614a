"""Bridge: MONET activation-checkpointing solutions → PyTorch selective
activation checkpointing (SAC).

The port's own copy of ``repro.core.remat_policy``: the same site names,
policy names and keep-set rules, with ``torch.utils.checkpoint`` in place of
``jax.checkpoint``.  A policy is a function
``(ctx, op, *args, **kwargs) -> CheckpointPolicy`` for
``create_selective_checkpoint_contexts``: it sees every ATen operator that the
checkpointed period runs in its forward and says whether its output is kept
(``MUST_SAVE``) or recomputed in the backward (``PREFER_RECOMPUTE``).

* ``dots`` keeps the outputs of the matrix products (``aten.mm``, ``addmm``,
  ``bmm``, ``baddbmm``: what ``x @ w`` and ``torch.einsum`` run), as
  ``jax.checkpoint_policies.checkpoint_dots`` keeps every ``dot_general``;
* ``dots_no_batch`` only the products without a batch dimension: ``mm``,
  ``addmm``, and a ``bmm`` whose operand is broadcast over the batch (what
  ``torch.matmul`` of a 3-D by a 2-D tensor runs when it does not fold the
  batch into the rows), as ``checkpoint_dots_with_no_batch_dims``;
* ``save:a,b`` and ``keepset_to_policy`` keep the values the models tag with
  ``checkpoint_name``.

The models tag eight sites.  A tag is an operator, so that the dispatch mode
sees it: ``aten.alias``, a view that copies nothing, issued only while a
policy that keeps names is active and with the site's name held in a
thread-local slot that the policy reads.  SAC stores the alias, which holds
the tagged tensor's storage; the recompute takes it from there.

A policy keeps nothing but a matrix product's output or a tagged alias.
The kernels launch through ctypes, which the dispatch mode does not see: on
the card a kernel wrapper dispatches only allocations and layout changes,
never what the kernel writes into them, so no policy keeps a kernel's output
and under remat the kernel is launched again in the recompute.  A tag after
a kernel's output (``attn_in`` after the norm kernel) is the way to keep it.
On the CPU the wrappers run the plain versions, whose products ``dots`` keeps.

Unlike XLA, SAC runs the whole period again in the recompute, also the work
that only fed a value it then takes from the cache: a ``save:`` policy saves
the reference's memory, not all of its time.
"""

from __future__ import annotations

import functools
import re
import threading

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

#: activation families tagged inside repro_torch.models (checkpoint_name sites)
KNOWN_SITES = (
    "attn_in", "qkv", "attn_probs", "attn_out", "mlp_in", "mlp_hidden",
    "mlp_out", "block_out", "ssm_in", "ssm_state", "moe_hidden", "logits",
)

_aten = torch.ops.aten
#: the ATen matrix products the models' ``@`` and ``einsum`` reach
PRODUCTS = frozenset({_aten.mm.default, _aten.addmm.default, _aten.bmm.default,
                      _aten.baddbmm.default})
_NO_BATCH = frozenset({_aten.mm.default, _aten.addmm.default})

SAVE, RECOMPUTE = CheckpointPolicy.MUST_SAVE, CheckpointPolicy.PREFER_RECOMPUTE


class _Scope(threading.local):
    """Per thread (the backward's recompute may run on the autograd engine's
    thread): the names being tagged (None: tags are off) and the name of the
    tag being issued."""
    tags: frozenset | None = None
    pending: str | None = None


_SCOPE = _Scope()


def checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    """Tag ``x`` as the site ``name``: an ``aten.alias`` of it while a policy
    that keeps ``name`` is active, else ``x`` itself (no operator)."""
    tags = _SCOPE.tags
    if tags is None or name not in tags:
        return x
    _SCOPE.pending = name
    try:
        return _aten.alias.default(x)
    finally:
        _SCOPE.pending = None


# -- policies -------------------------------------------------------------------------


def _batch_broadcast(op, args) -> bool:
    """A ``bmm`` / ``baddbmm`` one of whose operands is the same matrix for
    every batch entry (stride 0): a product without a batch dimension."""
    mats = args[:2] if op is _aten.bmm.default else args[1:3]
    return any(m.dim() == 3 and m.stride(0) == 0 for m in mats)


def checkpoint_dots(ctx, op, *args, **kwargs):
    return SAVE if op in PRODUCTS else RECOMPUTE


def checkpoint_dots_with_no_batch_dims(ctx, op, *args, **kwargs):
    if op in _NO_BATCH or (op in PRODUCTS and _batch_broadcast(op, args)):
        return SAVE
    return RECOMPUTE


def nothing_saveable(ctx, op, *args, **kwargs):
    return RECOMPUTE


class save_only_these_names:  # noqa: N801  (named as jax.checkpoint_policies')
    """Keeps exactly the values tagged with one of ``names``."""

    def __init__(self, *names: str):
        self.names = frozenset(names)

    def __call__(self, ctx, op, *args, **kwargs):
        if op is _aten.alias.default and _SCOPE.pending in self.names:
            return SAVE
        return RECOMPUTE

    def __repr__(self) -> str:
        return f"save_only_these_names{tuple(sorted(self.names))}"


POLICIES = {
    "none": None,                                    # no remat
    "full": "full_remat",                            # save nothing (recompute all)
    "dots": checkpoint_dots,
    "dots_no_batch": checkpoint_dots_with_no_batch_dims,
}


def policy_from_keep(keep_names) -> save_only_these_names:
    """A policy that saves exactly the named activation families."""
    return save_only_these_names(*(n for n in keep_names if n in KNOWN_SITES))


def family_of(tensor_name: str) -> str | None:
    """Map a MONET graph tensor name onto a model activation family."""
    t = tensor_name.lower()
    rules = [
        (r"\.(q|k|v|qkv)\.out", "qkv"),
        (r"softmax\.out|probs", "attn_probs"),
        (r"\.(av|merge|proj)\.out", "attn_out"),
        (r"\.(fc1|gelu|silu|up|gate)\.out", "mlp_hidden"),
        (r"\.(fc2|down)\.out", "mlp_out"),
        (r"ln\d?\.out|norm.*\.out", "attn_in"),
        (r"res\d\.out|add.*\.out", "block_out"),
        (r"ssm|scan", "ssm_state"),
    ]
    for pat, fam in rules:
        if re.search(pat, t):
            return fam
    return None


def keepset_to_policy(keep_tensors):
    """Full pipeline: MONET keep-set (graph tensor names) → SAC policy."""
    fams = sorted({f for f in (family_of(t) for t in keep_tensors) if f})
    if not fams:
        return nothing_saveable
    return save_only_these_names(*fams)


def resolve_remat(policy_name: str | None):
    """Config-level remat knob → (use_remat: bool, policy or None); ``None``
    with ``use_remat`` is full recompute."""
    if policy_name in (None, "none"):
        return False, None
    if policy_name == "full":
        return True, None   # checkpoint's default: save nothing extra
    if policy_name in POLICIES:
        return True, POLICIES[policy_name]
    if policy_name.startswith("save:"):
        names = [s for s in policy_name[5:].split(",") if s]
        return True, policy_from_keep(names)
    raise ValueError(f"unknown remat policy {policy_name!r}")


# -- running a function under a policy -----------------------------------------------


class _PolicyScope:
    """One of SAC's two contexts (forward, recompute), entered with the
    policy's tags switched on."""

    def __init__(self, inner, tags):
        self.inner, self.tags = inner, tags

    def __enter__(self):
        self.outer = _SCOPE.tags
        _SCOPE.tags = self.tags
        try:
            return self.inner.__enter__()
        except BaseException:
            _SCOPE.tags = self.outer
            raise

    def __exit__(self, *exc):
        try:
            return self.inner.__exit__(*exc)
        finally:
            _SCOPE.tags = self.outer


def _contexts(policy):
    # while a profiled step records, the policy counts the operators it judges
    # (imported here: ``core/__init__`` exports its modules by name, as the
    # reference's does, and the reference has no ``spans``)
    from . import spans
    fwd, rec = create_selective_checkpoint_contexts(spans.counted(policy))
    tags = getattr(policy, "names", None)
    return _PolicyScope(fwd, tags), _PolicyScope(rec, tags)


def checkpointed(fn, policy=None):
    """``fn`` under activation checkpointing, as ``jax.checkpoint(fn,
    policy=policy)``: ``None`` recomputes everything in the backward (no
    context), any other policy keeps what it selects.  Non-reentrant; no RNG
    state is kept (the models draw no random numbers)."""
    kw = {} if policy is None else {"context_fn": functools.partial(_contexts, policy)}

    @functools.wraps(fn)
    def run(*args):
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False, **kw)

    return run
