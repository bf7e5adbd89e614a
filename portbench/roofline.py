"""The yardstick of the kernels: the H100's published peaks, the least time
a piece of work can take on them, and the per-step counts that every
kernel's file (``portbench/kernels/<op>.py``) shares.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W
limit): 989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s fp32 outside them,
3.35 TB/s of HBM3.  A card set below 700 W runs slower: the run prints its
limit beside the shares.

The counts are of the operation's work, not of the implementation's
launches: one forward of each layer and one backward a step, whatever the
remat policy.  A forward kernel that the backward runs again to recompute
what was not kept is time spent above its bound, and shows as a lower share.
"""

from __future__ import annotations

PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12


def bound_ms(flops: float, nbytes: float, peak_flops: float) -> float:
    """max(FLOPs / peak, bytes / bandwidth), in ms."""
    return max(flops / peak_flops, nbytes / PEAK_BYTES) * 1e3


def itemsize(dtype: str) -> int:
    return {"float32": 4, "bfloat16": 2, "float16": 2}[dtype]


def mixers(model: dict) -> list[str]:
    """The mixer of each layer, from the configuration's pattern."""
    pat = model["pattern"]
    return [pat[i % len(pat)] for i in range(model["n_layers"])]


def tokens(job: dict) -> int:
    return job["batch"] * job["seq"]
