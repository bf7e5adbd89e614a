"""The port's dry-run on a fake (2, 2, 2) ('pod', 'data', 'model') process
group: the three cells of the reference's mini dry-run
(``tests/test_sharding.py::test_mini_multipod_dryrun``) at the smoke configs
(and, marked slow as there, at full size), three smoke cells on a (2, 4)
('data', 'model') mesh whose heads or groups do not divide 'model', the
kernel wrappers' refusals of placements they cannot take, and the collective
recorder.  Each group runs
in a subprocess (``tests/torch_mesh_worker.py dryrun``) under its own
timeout; this process starts none.

FLOPs (trap F): ``flops_global`` is the step's work counted once for the
whole mesh (``cell.GlobalFlops``: DTensor operators at their global shapes,
``local_map`` bodies at one rank's shapes times their split), every layer
(no scan counted once), the kernels as their plain versions on ``meta``.
So it is held against the reference's dry-run only through
``benchmarks.roofline.analytic_flops``, with each of its terms replaced by
what the port's step computes (``reckoned``), within 2 %:

* train: ``6 · N_active · B · S`` is kept (the products of forward and
  backward; ``dots`` recomputes none); the attention term
  (``3 · 2 · B · H · hd · S · T_eff``, causal-halved, a window's T_eff) is
  replaced by the plain kernels' products over the whole S × S score matrix,
  masked: forward 2, dq 3, dk/dv 4, ``2 · B · H · hd · S²`` each (``dots``
  keeps the plain forward's products as it keeps every matrix product; on
  the card it launches the forward kernel again, which the dry-run's plain
  path does not show); where the loss is chunked
  (``S · V > 2²⁸``) the unembedding's forward product is added once more
  (``2 · V · d · B · S``: each chunk's logits are recomputed in the
  backward);
* decode: the embedding gather is a lookup (``2 · V · d · B`` less where the
  embedding is not tied); the SSM recurrence's one product,
  ``2 · B · nh · hp · N``, stands for analytic's ``6 · …``; a MoE layer runs
  every expert's products over all its capacity slots (one token a routing
  group has ``C = 8`` slots an expert: ``E · C`` rows where analytic counts
  ``top_k``, as the reference's ``(B, E, C, D)`` einsums also do).

What stays outside the 2 %: the parameters that are no matrix (norm scales,
biases) and a MoE body's router, which each rank of the body's split runs.
Per device, ``flops`` counts every operator this rank runs, so
``flops × ranks ≥ flops_global``, replicated work counting on each rank.
"""

import json
import os
import subprocess
import sys

import pytest

import repro.configs as ref_configs
from benchmarks.roofline import analytic_flops

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_mesh_worker.py")
CELLS = [("gemma3-1b", "train_4k"), ("mamba2-1.3b", "decode_32k"),
         ("jamba-1.5-large-398b", "long_500k")]
BAND = 0.02
RANKS = 8


def run(size: str, timeout: int) -> dict:
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.path.join(
        os.path.dirname(os.path.dirname(WORKER)), "src"))
    out = subprocess.run([sys.executable, WORKER, "dryrun", size], capture_output=True,
                         text=True, env=env, timeout=timeout)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def smoke():
    return run("smoke", 300)


def reckoned(cfg, shape) -> float:
    """``analytic_flops`` with its terms replaced by what the port's step
    computes (the module docstring).  Covers the mixers and shapes of
    ``CELLS``."""
    B, S = shape.global_batch, shape.seq_len
    H, hd, specs = cfg.n_heads, cfg.head_dim_, cfg.layer_specs()
    out = analytic_flops(cfg, shape)
    if shape.kind == "train":
        assert all(s.mixer in ("attn", "local") and not s.moe for s in specs)
        assert cfg.remat in (None, "none", "dots"), cfg.remat   # no product recomputed
        products = 2 + 3 + 4
        for s in specs:
            t_eff = S if s.mixer == "attn" else min(S, cfg.window) * 2
            out += products * 2 * B * H * hd * S * S - 3 * 2 * B * H * hd * S * t_eff
        chunk = cfg.loss_chunk or (S // 8 if S * cfg.vocab > (1 << 28) and S % 8 == 0 else 0)
        if chunk and S > chunk:
            out += 2 * cfg.vocab * cfg.d_model * B * S
        return out
    assert shape.kind == "decode"
    if not cfg.tie_embeddings:
        out -= 2 * cfg.vocab * cfg.d_model * B
    if cfg.ssm:
        s = cfg.ssm
        out -= sum(4 * B * cfg.ssm_heads * s.headdim * s.d_state
                   for sp in specs if sp.mixer == "mamba")
    if cfg.moe:
        e = cfg.moe
        C = max(8, -(-int(e.capacity_factor * e.top_k / e.n_experts) // 8) * 8)
        mats = 3 if cfg.mlp in ("swiglu", "geglu") else 2
        out += sum(sp.moe for sp in specs) * 2 * B * (e.n_experts * C - e.top_k) * mats \
            * cfg.d_model * e.d_ff_expert
    return out


def check_cell(row, arch, shape_name, cfg):
    assert not row["error"], row["error"][:500]
    assert row["flops"] > 0 and row["n_collectives"] > 0, row
    assert row["n_collectives"] == row["comm_counts"]
    assert row["flops"] * RANKS >= row["flops_global"], row
    shape = ref_configs.get_shape(shape_name)
    want = reckoned(cfg, shape)
    assert abs(row["flops_global"] / want - 1) <= BAND, (
        row["flops_global"], want, analytic_flops(cfg, shape))


@pytest.mark.parametrize("arch,shape", CELLS)
def test_smoke_cells_lower(smoke, arch, shape):
    check_cell(smoke["cells"][f"{arch}:{shape}"], arch, shape, ref_configs.smoke_config(arch))


@pytest.mark.parametrize("cell", ["minicpm3-4b:train_4k", "mamba2-1.3b:train_4k",
                                  "nemotron-4-340b:decode_32k"])
def test_uneven_head_splits_lower(smoke, cell):
    """Heads or groups that do not divide 'model' = 4 on (data, model) =
    (2, 4) — 6 MLA heads, mamba2's 2 B/C groups, 6 kv heads — where the
    fused dim they are split from does: the split gathers that dim first
    (``sharding.unflatten``) and the cell lowers, as the production meshes'
    40 MLA heads, 2 groups and 8 kv heads on 'model' = 16 must."""
    row = smoke["uneven"][cell]
    assert not row["error"], row["error"][:500]
    assert row["flops"] > 0 and row["n_collectives"] == row["comm_counts"] > 0, row
    assert row["flops"] * RANKS >= row["flops_global"] > 0, row


@pytest.mark.slow
def test_full_size_cells_lower():
    """The same three cells at full size (the reference marks its own slow)."""
    out = run("full", 1200)
    for arch, shape in CELLS:
        check_cell(out["cells"][f"{arch}:{shape}"], arch, shape, ref_configs.get_config(arch))


@pytest.mark.parametrize("kernel,placement", [("flash", "S(1)"), ("rmsnorm", "S(2)"),
                                              ("ssd_chunk", "S(2)"), ("fused_adam", "P")])
def test_wrappers_refuse_placements_by_name(smoke, kernel, placement):
    """flash with the sequence sharded, rmsnorm with the normalised dim
    sharded, ssd_chunk with the chunk's rows sharded, fused_adam with g
    partial while p is sharded: each raises and names the placement; nothing
    is gathered in silence."""
    msg = smoke["refusals"][kernel]
    assert msg and placement in msg, msg


def test_collective_recorder(smoke):
    """One all-gather of a (64, 32) fp32 tensor: its result's 8192 bytes."""
    rec = smoke["recorder"]
    assert rec["n"] == 1 and rec["bytes"]["all-gather"] == 64 * 32 * 4
    assert sum(rec["bytes"].values()) == 64 * 32 * 4
