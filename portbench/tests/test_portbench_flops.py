"""The model-FLOP count against ``torch.utils.flop_counter.FlopCounterMode``
over the port's own plain step on ``meta``, remat off, for the products:
the weight products are 6·N·T, the experts' at exactly the tokens routed
to them (a capacity that drops and pads nothing), and attention's term is
the causal half of what the port's dense path computes."""

import dataclasses

import pytest
import torch
from conftest import ROOT
from torch.utils.flop_counter import FlopCounterMode

from portbench import harness, modelflops
from portbench.flops import attn

B, S = 2, 64


def meta_step_flops(cell):
    """(mm FLOPs, bmm FLOPs) of the port's loss, forward and backward, on meta."""
    from repro_torch.training.loss import lm_loss

    cfg = dataclasses.replace(harness.port_config(cell), remat="none", use_flash=False,
                              loss_chunk=S, attn_chunked=False)
    from repro_torch.models.transformer import abstract_params

    params = harness.flat(abstract_params(cfg))
    tree = harness.params_like(abstract_params(cfg), lambda p: params[p].requires_grad_(True))
    tokens = torch.zeros((B, S), dtype=torch.int32, device="meta")
    with FlopCounterMode(display=False) as fc:
        loss, _ = lm_loss(tree, cfg, tokens, tokens)
        torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    counts = fc.get_flop_counts()["Global"]
    get = lambda name: sum(v for k, v in counts.items() if str(k).startswith(name))
    return get("aten.mm"), get("aten.bmm")


def test_mamba2_products():
    cell = harness.resolve("mamba2-1.3b.train-b4s4096", ROOT)
    cell.config["model"]["n_layers"] = 2
    mm, _ = meta_step_flops(cell)
    assert mm == 6 * modelflops.matmul_params(cell.model, cell.family()) * B * S


def test_olmoe_products():
    cell = harness.resolve("olmoe-1b-7b.l8.train-b4s4096", ROOT)
    m = cell.config["model"]
    m["n_layers"] = 2
    # capacity = S·k/E exactly: the port's dispatched products are the routed ones
    m["moe"] = dict(m["moe"], capacity_factor=1.0)
    e = m["moe"]
    assert e["capacity_factor"] * S * e["top_k"] / e["n_experts"] % 8 == 0
    mm, bmm = meta_step_flops(cell)
    n = modelflops.matmul_params(cell.model, cell.family())
    experts = sum(s[0][0] * s[0][1] * s[0][2] * s[0][3] for s in
                  cell.family().leaves(m).values() if s[3] == "expert")
    active = experts * e["top_k"] / e["n_experts"]
    assert mm == 6 * (n - active) * B * S
    dense_attn = 3 * 2 * 2 * m["head_dim"] * B * m["n_heads"] * S * S * m["n_layers"]
    assert bmm == 6 * active * B * S + dense_attn
    assert attn.flops(m, B, S) * m["n_layers"] == pytest.approx(dense_attn * (S + 1) / (2 * S))
