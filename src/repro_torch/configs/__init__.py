"""Architecture registry: --arch <id> lookup + shape cells + reduced configs.

The port's own copy of `repro.configs` (pure data, no framework).

Every assigned architecture exposes:
  CONFIG          — the exact full-size ModelConfig from the assignment
  reduced()       — a same-family small config for CPU smoke tests
Shapes (assignment): train_4k / prefill_32k / decode_32k / long_500k; the
skip matrix for long_500k lives here (see DESIGN.md §5).
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List, Optional, Tuple

from repro_torch.models.config import ModelConfig

ARCH_IDS = (
    "whisper_small",
    "dbrx_132b",
    "deepseek_v3_671b",
    "jamba_1_5_large_398b",
    "stablelm_12b",
    "phi3_medium_14b",
    "gemma_2b",
    "command_r_plus_104b",
    "qwen2_vl_2b",
    "mamba2_780m",
)

#: canonical dash-form aliases (--arch whisper-small etc.)
ALIASES = {a.replace("_", "-"): a for a in ARCH_IDS}


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Tuple[ShapeCell, ...] = (
    ShapeCell("train_4k", 4_096, 256, "train"),
    ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    ShapeCell("decode_32k", 32_768, 128, "decode"),
    ShapeCell("long_500k", 524_288, 1, "decode"),
)

#: long_500k runs only for sub-quadratic-decode archs (SSM/hybrid);
#: pure full-attention archs skip it (noted in DESIGN.md §5).
LONG_CONTEXT_ARCHS = ("mamba2_780m", "jamba_1_5_large_398b")


def get_config(arch: str) -> ModelConfig:
    arch = ALIASES.get(arch, arch)
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.CONFIG


def get_reduced(arch: str) -> ModelConfig:
    arch = ALIASES.get(arch, arch)
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.reduced()


def cells_for(arch: str) -> List[ShapeCell]:
    arch = ALIASES.get(arch, arch)
    out = []
    for s in SHAPES:
        if s.name == "long_500k" and arch not in LONG_CONTEXT_ARCHS:
            continue
        out.append(s)
    return out


def all_cells() -> List[Tuple[str, ShapeCell]]:
    return [(a, s) for a in ARCH_IDS for s in cells_for(a)]
