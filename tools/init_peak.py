"""Peak device bytes of ``Model.init`` for a configuration on the card, in
the tree of the current directory (its ``src/``). Needs one CUDA device:

    cd <tree> && python3 <checkout>/tools/init_peak.py [--arch qwen3-1.7b] [--layers N]

Draws the configuration's bf16 weights on the card from a seed (as
``chip_smoke.py``'s serve phase does) and prints one JSON line: the tree, the
architecture and depth, the parameters' bytes, the peak bytes allocated
during ``init`` (``torch.cuda.max_memory_allocated`` after
``reset_peak_memory_stats``), the seconds it took, a digest of the weights'
bytes (equal digests: the same weights), and the card's name and power
limit. Run it in two trees in one call to compare their ``init``.
"""

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--layers", type=int, default=0, help="cut the depth to this many layers (0: the config's)")
    ap.add_argument("--seed", type=int, default=1000)
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(os.getcwd(), "src"))
    import torch

    from repro_torch import tree
    from repro_torch.configs import get
    from repro_torch.models import build_model

    if not torch.cuda.is_available():
        print("init_peak: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    cfg = get(args.arch)
    if args.layers:
        cfg = cfg.replace(n_layers=args.layers)
    model = build_model(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(gen)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    digest = hashlib.sha256()
    for t in tree.leaves(params):
        digest.update(t.contiguous().view(torch.uint8).reshape(-1).cpu().numpy().tobytes())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"tree": os.getcwd(), "arch": cfg.name, "layers": cfg.n_layers,
                      "param_bytes": sum(t.numel() * t.element_size() for t in tree.leaves(params)),
                      "init_peak_bytes": peak, "init_s": seconds, "sha256": digest.hexdigest(), "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
