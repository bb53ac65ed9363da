"""``coded.rs_checkpoint.encode_parity(limbs, plan)``: the coded checkpoint's
single-program encode, the universal prepare-and-shoot of the configuration's
Cauchy generator, run over column blocks."""

from __future__ import annotations


def build(config: dict, options: dict, device):
    from repro_torch.coded.rs_checkpoint import build_parity_plan, encode_parity

    code = config["code"]
    if code["generator"]["construction"] != "cauchy" or code["N"] != code["K"]:
        raise ValueError("encode_parity codes K replicas into K parities with the Cauchy generator")
    plan = build_parity_plan(code["K"], p=code["p"], q=code["q"])
    return lambda x: encode_parity(x, plan)
