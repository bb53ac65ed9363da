"""Times ``gf_matmul``'s CUDA kernel at chosen shapes on one CUDA device, in the
tree of the current directory (its ``chip_smoke.py`` and ``src/``), so that two
trees can be compared on one card. Run from a tree's root:

    cd <tree> && python3 <checkout>/tools/gf_matmul_shapes.py [SET ...]   # ~1 min a set on an H100

Sets (``table`` where none is named):

* ``table``: the coded guards' shapes (every N % 4, the scalar table of
  ``PERF.md``) and the main path's aligned ones;
* ``twins``: each large ragged shape of the table with N rounded down to a
  multiple of 4, so that the same bytes run in the aligned form;
* ``sweep``: 8 x (2x4).(4xN) from N = 39,820 to 4,044,801, each N aligned
  and one more (ragged);
* ``batch``: batch 1 to 64 x (2x4).(4xN) at N = 39,820 and 39,821;
* ``offsets``: 8 x (2x4).(4xN) with N % 4 == 0 and B, C or both at a 4-byte
  offset (views), at N = 126,400 and 19,573,468 (needs the launcher's
  ``out=``, which older trees lack: the set is then skipped).

The first three sets go through ``chip_smoke.check_gf_matmul``, which holds
every shape bit for bit against the plain version (after its forms check)
and times it as phase ``kernels`` does: 30 launches in a CUDA graph over
copies of the inputs past 100 MB, / 30. Prints the card's name and power
limit, then one JSON line a shape.
"""

import json
import os
import sys

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

M31, NTT = cs.M31, cs.NTT
TABLE = [
    # aligned: the main path's encode shapes and the guards with N % 4 == 0
    ((64, 8, 8, 1 << 20), M31), ((1, 2, 4, 1 << 20), M31), ((1, 3, 3, 1 << 20), M31), ((1, 4, 2, 1 << 20), M31),
    ((1, 4, 4, 1 << 20), M31), ((1, 2, 4, 39148204), NTT), ((8, 2, 4, 39148204), NTT), ((64, 16, 4, 1 << 20), M31),
    ((64, 4, 8, 1 << 20), M31), ((64, 2, 8, 1 << 20), M31), ((3, 2, 2, 1 << 24), NTT), ((3, 2, 2, 11187552), NTT),
    ((48, 2, 2, 1 << 20), NTT), ((8, 4, 2, 16384), M31),
    # ragged: the coded guards, at the depths PERF.md's table names
    ((8, 2, 4, 19573470), NTT), ((8, 2, 4, 39146889), NTT), ((1, 2, 2, 117440585), NTT), ((1, 2, 2, 29360201), NTT),
    ((5, 2, 4, 78293713), NTT), ((5, 2, 4, 19573457), NTT), ((1, 4, 4, 15730001), M31), ((16, 4, 4, 15730001), M31),
    ((8, 2, 4, 16777827), NTT), ((8, 2, 4, 33555043), NTT), ((8, 2, 4, 8389219), NTT), ((8, 2, 4, 4194915), NTT),
    ((8, 2, 4, 68825761), M31), ((16, 4, 4, 375001), M31), ((8, 2, 4, 2796254), NTT), ((8, 2, 4, 1572915), NTT),
    ((8, 2, 4, 3550478), NTT), ((8, 2, 4, 1775545), NTT), ((8, 2, 4, 888078), NTT), ((8, 2, 4, 2037689), NTT),
    ((8, 2, 4, 2609763), NTT), ((1, 2, 2, 4718681), NTT), ((1, 2, 2, 2662473), NTT), ((1, 2, 2, 4276297), NTT),
    ((1, 2, 2, 5324897), NTT), ((8, 2, 4, 126401), M31), ((8, 2, 4, 79561), M31), ((8, 2, 4, 59121), M31),
    ((8, 2, 4, 39821), M31), ((16, 4, 4, 1), M31),
]
TWINS = [((B, M, K, N - N % 4), q) for (B, M, K, N), q in TABLE if N % 4 and 4 * B * K * N > (64 << 20)]
SWEEP = [((8, 2, 4, n + d), M31) for n in (39820, 79560, 126400, 252800, 505600, 1011200, 4044800) for d in (0, 1)]
BATCH = [((b, 2, 4, n), M31) for b in (1, 2, 4, 8, 16, 32, 64) for n in (39820, 39821)]
SETS = {"table": TABLE, "twins": TWINS, "sweep": SWEEP, "batch": BATCH}


def offsets(dev) -> list[dict]:
    """8 x (2x4).(4xN), N % 4 == 0, with B, C or both a view at a 4-byte offset."""
    import inspect

    from repro_torch.kernels.gf_matmul.kernel import gf_matmul_launcher, gf_matmul_plain, row_form

    if "out" not in inspect.signature(gf_matmul_launcher).parameters:
        print("offsets: this tree's launcher takes no out=; skipped", flush=True)
        return []

    def view(shape, words, seed=None):
        n = words + shape[0] * shape[1] * shape[2]
        flat = torch.empty(n, dtype=torch.int32, device=dev) if seed is None else cs.rand_residues((n,), M31, dev, seed)
        return flat[words:].view(shape)

    rows = []
    for N in (126400, 19573468):
        for b_off, c_off in ((0, 0), (1, 0), (0, 1), (1, 1)):
            nbytes = 4 * 8 * (2 * 4 + 4 * N + 2 * N)
            launchers = []
            for i in range(cs.copies_for(nbytes)):
                a, b = view((8, 2, 4), 0, seed=2 * i), view((8, 4, N), b_off, seed=2 * i + 1)
                launch, out = gf_matmul_launcher(a, b, M31, out=view((8, 2, N), c_off))
                if i == 0:
                    launch()
                    cs.check(cs.same(out, gf_matmul_plain(a, b, M31)), f"gf_matmul != plain at B+{b_off}, C+{c_off}")
                    form = row_form(N, b.data_ptr(), out.data_ptr())
                launchers.append(launch)
            ms = cs.kernel_ms(launchers)
            rows.append({"set": "offsets", "shape": f"batch 8 x (2x4).(4x{N})", "b_words": b_off, "c_words": c_off,
                         "form": form, "ms": ms, "bound_ms": nbytes / cs.HBM_BYTES_PER_S * 1e3,
                         "input_copies": len(launchers)})
            del launchers
    return rows


def main():
    names = sys.argv[1:] or ["table"]
    for n in names:
        if n not in SETS and n != "offsets":
            sys.exit(f"unknown set {n!r}: one of {sorted(SETS) + ['offsets']}")
    if not torch.cuda.is_available():
        sys.exit("gf_matmul_shapes: needs a CUDA device")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    print(cs.nvidia_smi_line(), torch.__version__, os.getcwd(), flush=True)
    cs._build.build_all()
    shapes = [(s, q, [n]) for n in names if n in SETS for s, q in SETS[n]]
    if shapes:
        row = cs.check_gf_matmul(dev, shapes)
        for r in row["shapes"]:
            print(json.dumps({"set": r["from"][0], **{k: r.get(k) for k in (
                "shape", "q", "m_tile", "form", "ms", "bound_ms", "share_of_bound", "host_us", "plain_ms",
                "input_copies")}}), flush=True)
    if "offsets" in names:
        for r in offsets(dev):
            print(json.dumps({**r, "share_of_bound": r["bound_ms"] / r["ms"]}), flush=True)


if __name__ == "__main__":
    main()
