"""``core.encode.a2a_encode(x, plan=...)``: the single-program encode with the
plan of the configuration's generator (the butterfly for a digit-reversed
DFT)."""

from __future__ import annotations

PLAN_KIND = {"dft_digit_reversed": "dft"}


def build(config: dict, options: dict, device):
    from repro_torch.core.encode import a2a_encode, plan_for

    code = config["code"]
    construction = code["generator"]["construction"]
    if construction not in PLAN_KIND:
        raise ValueError(f"a2a_encode has no plan for the {construction} generator")
    plan = plan_for(PLAN_KIND[construction], code["K"], code["p"], code["q"])
    return lambda x: a2a_encode(x, plan=plan, q=code["q"], device=device)[0]
