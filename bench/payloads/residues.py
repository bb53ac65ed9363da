"""K rows of residues drawn uniformly from [0, q) on the device. The program
gets its own copy, so that nothing it does to its input reaches the rows the
reference reads."""

from __future__ import annotations

import torch


def make(config: dict, device: torch.device, generator: torch.Generator) -> torch.Tensor:
    code = config["code"]
    return torch.randint(0, code["q"], (code["K"], width(config)), generator=generator, device=device,
                         dtype=torch.int32)


def width(config: dict) -> int:
    return int(config["payload"]["elements_per_node"])


def to_program(raw, config: dict, device: torch.device) -> torch.Tensor:
    return raw.to(device, copy=True)


def to_reference(raw, config: dict) -> torch.Tensor:
    return raw
