"""Architecture registry: ``--arch <id>`` resolution + cell (arch × shape)
feasibility rules."""

from __future__ import annotations

import importlib

from .base import SHAPES, ModelConfig, ShapeConfig, reduced

_MODULES = {
    "nemotron-4-340b": "nemotron_4_340b",
    "gemma3-1b": "gemma3_1b",
    "phi3-medium-14b": "phi3_medium_14b",
    "minicpm3-4b": "minicpm3_4b",
    "mamba2-1.3b": "mamba2_1_3b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "internvl2-26b": "internvl2_26b",
    "musicgen-medium": "musicgen_medium",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
}

ARCH_IDS = list(_MODULES)

#: archs with sub-quadratic sequence mixing (run long_500k)
SUB_QUADRATIC = {"gemma3-1b", "mamba2-1.3b", "jamba-1.5-large-398b"}


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def cell_status(arch: str, shape: str) -> str:
    """'run' or a skip reason, per the assignment rules."""
    if shape == "long_500k" and arch not in SUB_QUADRATIC:
        return ("skip: pure full-attention arch — 512k decode requires "
                "sub-quadratic sequence mixing (see DESIGN.md)")
    return "run"


def all_cells() -> list[tuple[str, str, str]]:
    """Every (arch, shape, status) — the 40-cell table."""
    return [(a, s, cell_status(a, s)) for a in ARCH_IDS for s in SHAPES]


def smoke_config(arch: str) -> ModelConfig:
    return reduced(get_config(arch))
