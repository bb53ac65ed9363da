"""Times the row kernel's ragged form against variants that each undo one of
its design choices, on one CUDA device, in the tree of the current directory.
Each variant is a textual edit of ``src/repro_torch/csrc/gf_matmul.cu``,
built beside the source into ``build/gf_matmul_variants/`` (the source is not
changed), and held bit for bit against the plain version before it is
timed. Run from a tree's root:

    python3 tools/gf_matmul_variants.py     # ~1 min on an H100

* ``source``: the kernel as it stands;
* ``seam_streaming``: the words at a warp's seams and a row's tail written
  with the streaming hint (``st.global.cs``), as the 16-byte chunks are;
* ``switch_reads``: a B row's four words a group taken at its phase by one
  switch a row into code with the words fixed at compile time, not by nine
  run-time selects a group;
* ``store_switch``: a C row's stores by one switch a row into code with its
  phase fixed at compile time (no shuffle where the row is aligned, no
  select), not by run-time selects over three shuffled words;
* ``async_edges``: a B row's edge words issued as asynchronous 4-byte copies
  (``cp.async``) that arrive on the stage's barrier, not loaded into
  registers before the producer's wait.

Times are those of ``chip_smoke.kernel_ms`` (30 launches in a CUDA graph over
copies of the inputs past 100 MB, / 30), in two rounds in opposite orders.
Prints the card's name and power limit, then one JSON line a shape.
"""

import ctypes
import json
import os
import subprocess
import sys

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.gf_matmul.kernel import gf_matmul_plain, launch_plan  # noqa: E402

SOURCE = "src/repro_torch/csrc/gf_matmul.cu"
OUT = "build/gf_matmul_variants"
M31, NTT = cs.M31, cs.NTT
SHAPES = [((16, 4, 4, 15730001), M31), ((1, 4, 4, 15730001), M31), ((8, 2, 4, 19573470), NTT),
          ((1, 2, 2, 117440585), NTT), ((8, 2, 4, 126401), M31), ((64, 8, 8, 1 << 20), M31)]

LOAD_SELECTS = """const int ph = phase_of(B + (z * K + k) * N + n0);
#pragma unroll
                    for (int g = 0; g < T::G; ++g) {
                        const uint4* c = reinterpret_cast<const uint4*>(at + g * kGroupStride);
                        const uint4 t = funnel(c[0], c[1], ph);
                        b[4 * g] = t.x; b[4 * g + 1] = t.y; b[4 * g + 2] = t.z; b[4 * g + 3] = t.w;
                    }"""

LOAD_SWITCH = """switch (phase_of(B + (z * K + k) * N + n0)) {
                        case 0: read_ragged<T::G, 0>(b, at); break;
                        case 1: read_ragged<T::G, 1>(b, at); break;
                        case 2: read_ragged<T::G, 2>(b, at); break;
                        default: read_ragged<T::G, 3>(b, at); break;
                    }"""

READ_RAGGED = """template <int G, int P>
__device__ __forceinline__ void read_ragged(uint32_t* b, const uint32_t* at) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
        const uint4* c = reinterpret_cast<const uint4*>(at + g * kGroupStride);
        const uint4 t = P == 0 ? c[0] : funnel(c[0], c[1], P);
        b[4 * g] = t.x; b[4 * g + 1] = t.y; b[4 * g + 2] = t.z; b[4 * g + 3] = t.w;
    }
}

"""

STORE_SELECTS = """const int s = (4 - phase_of(crow)) & 3;
#pragma unroll
            for (int g = 0; g < T::G; ++g) {
                const long long col = g * kGroupStride + tid * 4;
                uint4 next;  // the next lane's first three words: every lane shuffles
                next.x = __shfl_down_sync(0xffffffffu, o[g].x, 1);
                next.y = __shfl_down_sync(0xffffffffu, o[g].y, 1);
                next.z = __shfl_down_sync(0xffffffffu, o[g].z, 1);
                next.w = 0u;
                if (s == 0 || lane < 31) store_chunk(crow, col + s, funnel(o[g], next, s), cols);
                if (s != 0 && (lane == 0 || lane == 31)) {  // the words at the warp's seams
                    const uint32_t w[4] = {o[g].x, o[g].y, o[g].z, o[g].w};
#pragma unroll
                    for (int j = 0; j < 4; ++j)
                        if ((lane == 0) == (j < s) && col + j < cols) crow[col + j] = w[j];
                }
            }"""

STORE_SWITCH = """switch ((4 - phase_of(crow)) & 3) {
                case 0:
#pragma unroll
                    for (int g = 0; g < T::G; ++g) store_chunk(crow, g * kGroupStride + tid * 4, o[g], cols);
                    break;
                case 1: store_ragged<T::G, 1>(crow, o, tid * 4, cols, lane); break;
                case 2: store_ragged<T::G, 2>(crow, o, tid * 4, cols, lane); break;
                default: store_ragged<T::G, 3>(crow, o, tid * 4, cols, lane); break;
            }"""

STORE_RAGGED = """template <int G, int S>
__device__ __forceinline__ void store_ragged(uint32_t* row, const uint4* o, long long col0, long long cols, int lane) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
        const long long col = col0 + g * kGroupStride;
        uint4 next;
        next.x = __shfl_down_sync(0xffffffffu, o[g].x, 1);
        next.y = S >= 2 ? __shfl_down_sync(0xffffffffu, o[g].y, 1) : 0u;
        next.z = S >= 3 ? __shfl_down_sync(0xffffffffu, o[g].z, 1) : 0u;
        next.w = 0u;
        if (lane < 31) store_chunk(row, col + S, funnel(o[g], next, S), cols);
        if (lane == 0 || lane == 31) {
            const uint32_t w[4] = {o[g].x, o[g].y, o[g].z, o[g].w};
#pragma unroll
            for (int j = 0; j < 4; ++j)
                if ((lane == 0) == (j < S) && col + j < cols) row[col + j] = w[j];
        }
    }
}

"""

ASYNC_EDGE_STORE = """if (kRagged) {
#pragma unroll
                    for (int j = 0; j < T::EdgeRegs; ++j)
                        if (e_at[j] >= 0)
                            asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_u32(dst + e_at[j])),
                                         "l"(e_reg[j]) : "memory");
                    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(smem_u32(&full[stage]))
                                 : "memory");
                }"""

STORE_CHUNK_DOC = "// Four words to row `row` at columns c .. c+3"
MBAR_INIT = "__device__ __forceinline__ void mbar_init"

# variant -> [(text in the source, its replacement)]; every text must be found
EDITS = {
    "source": [],
    "seam_streaming": [
        ("if (c + j < cols) row[c + j] = w[j];", "if (c + j < cols) __stcs(row + c + j, w[j]);"),
        ("if ((lane == 0) == (j < s) && col + j < cols) crow[col + j] = w[j];",
         "if ((lane == 0) == (j < s) && col + j < cols) __stcs(crow + col + j, w[j]);"),
    ],
    "switch_reads": [
        (LOAD_SELECTS, LOAD_SWITCH),
        (STORE_CHUNK_DOC, READ_RAGGED + STORE_CHUNK_DOC),
    ],
    "store_switch": [(STORE_SELECTS, STORE_SWITCH), (MBAR_INIT, STORE_RAGGED + MBAR_INIT)],
    "async_edges": [
        ("mbar_init(&full[s], 1);", "mbar_init(&full[s], kRagged ? 1 + 32 : 1);"),
        ("uint32_t e_reg[T::EdgeRegs > 0 ? T::EdgeRegs : 1];",
         "const uint32_t* e_reg[T::EdgeRegs > 0 ? T::EdgeRegs : 1];"),
        ("e_reg[j] = row[col];", "e_reg[j] = row + col;"),
        ("""#pragma unroll
                for (int j = 0; j < T::EdgeRegs; ++j)
                    if (e_at[j] >= 0) dst[e_at[j]] = e_reg[j];""", ASYNC_EDGE_STORE),
    ],
}


def build() -> dict:
    text = open(SOURCE).read()
    os.makedirs(OUT, exist_ok=True)
    nvcc, procs = _build.find_nvcc(), {}
    for name, edits in EDITS.items():
        src = text
        for old, new in edits:
            if old not in src:
                sys.exit(f"gf_matmul_variants: {name}: the source no longer holds {old[:60]!r}")
            src = src.replace(old, new)
        path = os.path.join(OUT, f"{name}.cu")
        with open(path, "w") as f:
            f.write(src)
        lib = os.path.join(OUT, f"lib{name}.so")
        procs[name] = (lib, subprocess.Popen([nvcc, *_build.NVCC_FLAGS, "-o", lib, path], stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"gf_matmul_variants: {name} failed to build:\n{log}")
        print(json.dumps({"variant": name, "ptxas": cs.ptxas_by_kernel(log)[:2]}), flush=True)
        fn = ctypes.CDLL(os.path.abspath(lib)).gf_matmul_launch
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                                               ctypes.c_uint, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main():
    if not torch.cuda.is_available():
        sys.exit("gf_matmul_variants: needs a CUDA device")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    print(cs.nvidia_smi_line(), torch.__version__, flush=True)
    fns = build()
    for i, ((B, M, K, N), q) in enumerate(SHAPES):
        nbytes = 4 * B * (M * K + K * N + M * N)
        inputs = [(cs.rand_residues((B, M, K), q, dev, seed=10 * i + 2 * c),
                   cs.rand_residues((B, K, N), q, dev, seed=10 * i + 2 * c + 1)) for c in range(cs.copies_for(nbytes))]
        outs = [torch.empty((B, M, N), dtype=torch.int32, device=dev) for _ in inputs]
        m_tile = launch_plan(M, N, inputs[0][1].data_ptr(), outs[0].data_ptr())
        want = gf_matmul_plain(*inputs[0], q)

        def launchers(fn):
            def one(a, b, c):
                def launch():
                    err = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), B, M, K, N, q, m_tile, 0,
                             torch.cuda.current_stream().cuda_stream)
                    cs.check(err == 0, f"gf_matmul_launch failed with CUDA error {err}")
                return launch
            return [one(a, b, c) for (a, b), c in zip(inputs, outs)]

        ms = {}
        for rnd in range(2):
            for name in (list(fns) if rnd == 0 else list(fns)[::-1]):
                ls = launchers(fns[name])
                if rnd == 0:
                    outs[0].zero_()
                    ls[0]()
                    torch.cuda.synchronize()
                    cs.check(cs.same(outs[0], want), f"{name} != plain at {(B, M, K, N)}")
                ms.setdefault(name, []).append(cs.kernel_ms(ls))
        print(json.dumps({"shape": f"batch {B} x ({M}x{K}).({K}x{N})", "q": q, "m_tile": m_tile,
                          "bound_ms": nbytes / cs.HBM_BYTES_PER_S * 1e3, "input_copies": len(inputs), "ms": ms}),
              flush=True)
        del inputs, outs, want
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
