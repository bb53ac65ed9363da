"""``dist.collectives``' round schedule on one device: the IR executor
(``ir_encode``) running the plan of the configuration's generator, one row a
processor (``butterfly`` for a digit-reversed DFT). ``options["kernels"]``
is the executor's LocalOp lowering."""

from __future__ import annotations


def build(config: dict, options: dict, device):
    from repro_torch.dist.collectives import butterfly

    code = config["code"]
    gen = code["generator"]
    if gen["construction"] != "dft_digit_reversed" or gen["radix"] != code["p"] + 1:
        raise ValueError("the IR entry runs the radix-(p+1) butterfly of a digit-reversed DFT")
    fn, _ = butterfly(code["K"], p=code["p"], q=code["q"], device=device, kernels=options.get("kernels"))
    return fn
