"""Differential tests of the port's coded layer (``repro_torch.tree`` and
``repro_torch.coded``) against ``repro.coded`` on the CPU.

The same seeded numpy inputs go through the reference (on the JAX CPU
backend) and, carried across by ``repro_torch.convert.state_from_reference``,
through the port with ``device="cpu"``. Limbs, parity, recovered shards, LCC
generators, encodes and decodes must be equal — tolerance 0 (exact integer
arithmetic mod q). Gradient coding is float32 arithmetic: it is held at
rtol 1e-6 (the reference's own test holds the decoded sum at 1e-4). One test
forks a process with 8 forced host devices and runs the reference's mesh
``encode_parity_collective``; the port's one-device collective forms must
equal it.

Each reference encode is a JAX program compiled for its shape, seconds on
the CPU. So the reference's encode functions run at one case of each kind,
and the other cases hold the port against the reference's exact host oracle
(``repro.core.prepare_shoot.encode_oracle``) applied to the reference's own
generator.
"""

import gc
import os
import subprocess
import sys
import textwrap
import weakref
from collections import OrderedDict, namedtuple

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.coded import gradient_coding as rgc
from repro.coded import lagrange_compute as rlc
from repro.coded import rs_checkpoint as rrs
from repro.core.field import M31, NTT, Field
from repro.core.prepare_shoot import encode_oracle
from repro.train.checkpoint import _flatten_with_names as r_flatten_with_names
from repro_torch import coded as pcoded
from repro_torch import tree
from repro_torch.coded import gradient_coding as pgc
from repro_torch.coded import lagrange_compute as plc
from repro_torch.coded import rs_checkpoint as prs
from repro_torch.convert import from_reference, state_from_reference, to_numpy, to_tensor
from test_torch_plans import plans_equal

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def t32(a):
    return to_tensor(np.asarray(a, dtype=np.uint32), "cpu")


def bits(t: torch.Tensor) -> np.ndarray:
    """A tensor's bytes (a bool as its 0/1 byte), for bit-for-bit equality."""
    t = t.detach().cpu().contiguous().reshape(-1)
    return (t.to(torch.uint8) if t.dtype == torch.bool else t.view(torch.uint8)).numpy()


def ref_bits(a) -> np.ndarray:
    """The bytes of a leaf as the reference reads it (``jnp.asarray``)."""
    a = np.ascontiguousarray(np.asarray(jnp.asarray(a))).reshape(-1)
    return a.astype(np.uint8) if a.dtype == bool else a.view(np.uint8)


def ref_dtype(a) -> str:
    return jnp.asarray(a).dtype.name


def mixed_state(seed: int = 0):
    """float32, bfloat16, int32, a 0-d leaf, a bool leaf of odd byte count,
    ``None``, dict keys inserted out of sorted order, an ``OrderedDict`` read
    in insertion order, and leaves the reference reads at 32 bits: a Python
    ``int``, a Python ``float`` and float64 and int64 numpy arrays."""
    rng = np.random.default_rng(seed)
    return {
        "w": rng.normal(size=(7, 5)).astype(np.float32),
        "b16": jnp.asarray(rng.normal(size=(3, 3)), dtype=jnp.bfloat16),
        "opt": {"step": np.int32(123), "m": rng.normal(size=(11,)).astype(np.float32), "none": None},
        "mask": rng.integers(0, 2, size=(5,)).astype(bool),
        "idx": [np.arange(9, dtype=np.int32), None, (rng.normal(size=(2,)).astype(np.float32),)],
        "a": np.float32(-0.5),
        "ordered": OrderedDict([("z", rng.normal(size=(3,))), ("count", -(7 + seed)), (
            "b", [np.arange(-2, 3), 0.25 + seed])]),
    }


# ---------------------------------------------------------------------------
# tree: JAX's order and leaf set
# ---------------------------------------------------------------------------

TREES = {
    "unsorted-dict": {"z": 1, "a": 2, "m": {"y": 3, "b": 4}},
    "none-node": [None, 1, (None, 2)],
    "nested": {"b": [1, {"d": (2, 3), "c": None}], "a": (), "e": [], "f": {}},
    "single-tuple": (5,),
    "leaf": 7,
    "mixed-state": mixed_state(),
}


@pytest.mark.parametrize("name", sorted(TREES))
def test_tree_order_leaves_names_and_structure_equal_jax(name):
    t = TREES[name]
    leaves, treedef = tree.flatten(t)
    r_leaves, r_treedef = jax.tree.flatten(t)
    assert len(leaves) == len(r_leaves) == treedef.num_leaves
    assert all(a is b for a, b in zip(leaves, r_leaves))
    assert str(treedef) == str(r_treedef)
    named = tree.flatten_with_names(t)
    r_named = r_flatten_with_names(t)
    assert list(named) == list(r_named)
    assert all(named[k] is r_named[k] for k in named)
    back = tree.unflatten(treedef, leaves)
    assert jax.tree.structure(back) == r_treedef
    assert tree.structure(back) == treedef
    same = tree.map(lambda a, b: a is b, t, back)
    assert tree.structure(same) == treedef and all(tree.leaves(same))


def test_tree_namedtuple_and_subclasses_as_jax():
    """A namedtuple is a node read in field order and rebuilt as its class;
    a subclass of ``dict`` or ``tuple`` is a leaf, as in JAX."""
    Pair = namedtuple("Pair", ["b", "a"])

    class D(dict):
        pass

    class T(tuple):
        pass

    t = {"p": Pair(1, (None, 2)), "d": D(x=3), "t": T((4, 5)), "o": OrderedDict()}
    leaves, treedef = tree.flatten(t)
    r_leaves, r_treedef = jax.tree.flatten(t)
    assert len(leaves) == len(r_leaves) == 4 and all(a is b for a, b in zip(leaves, r_leaves))
    assert str(treedef) == str(r_treedef)
    back = tree.unflatten(treedef, leaves)
    assert type(back["p"]) is Pair and type(back["o"]) is OrderedDict
    assert jax.tree.structure(back) == r_treedef
    assert list(tree.flatten_with_names(t)) == ["d", "p/b", "p/a/1", "t"]


def test_tree_unflatten_holds_no_leaf_in_a_reference_cycle():
    """A rebuilt tree's leaves are freed by reference counting alone, with
    Python's cyclic collector off."""
    t = {"a": [torch.zeros(3), (torch.ones(2), None)], "b": OrderedDict(c=torch.arange(4))}
    leaves, treedef = tree.flatten(t)
    refs = [weakref.ref(x) for x in leaves]
    gc.collect()
    gc.disable()
    try:
        back = tree.unflatten(treedef, [x.clone() for x in leaves])
        rebuilt = [weakref.ref(x) for x in tree.leaves(back)]
        del back
        assert all(r() is None for r in rebuilt)
        del t, leaves
        assert all(r() is None for r in refs)
    finally:
        gc.enable()


def test_tree_rejects_mismatches():
    _, td = tree.flatten({"a": 1, "b": [2, 3]})
    with pytest.raises(ValueError, match="4 leaves for a tree of 3"):
        tree.unflatten(td, [1, 2, 3, 4])
    with pytest.raises(ValueError, match="structures differ"):
        tree.map(lambda a, b: a, {"a": 1}, {"b": 1})


# ---------------------------------------------------------------------------
# limbs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_limbs_equal_reference_and_round_trip(seed):
    st = mixed_state(seed)
    r_limbs, r_meta = rrs.state_to_limbs(st)
    pst = state_from_reference(st, "cpu")
    limbs, meta = prs.state_to_limbs(pst, "cpu")
    assert limbs.dtype == torch.int32 and limbs.device.type == "cpu"
    assert np.array_equal(to_numpy(limbs), np.asarray(r_limbs))
    assert meta.sizes_u16 == r_meta.sizes_u16 and meta.total == r_meta.total
    assert meta.shapes == [tuple(s) for s in r_meta.shapes]
    assert [str(d).replace("torch.", "") for d in meta.dtypes] == [np.dtype(d).name for d in r_meta.dtypes]
    assert str(meta.treedef) == str(r_meta.treedef)
    back = prs.limbs_to_state(limbs, meta)
    r_back = rrs.limbs_to_state(r_limbs, r_meta)
    for a, b, r in zip(tree.leaves(back), tree.leaves(pst), jax.tree.leaves(r_back)):
        assert a.dtype == b.dtype and tuple(a.shape) == tuple(b.shape)
        assert np.array_equal(bits(a), bits(b))
        assert np.array_equal(bits(a), ref_bits(r))


def test_state_from_reference_moves_bits_and_dtypes():
    st = mixed_state(3)
    pst = state_from_reference(st, "cpu")
    for p, r in zip(tree.leaves(pst), jax.tree.leaves(st)):
        assert str(p.dtype).replace("torch.", "") == ref_dtype(r)
        assert np.array_equal(bits(p), ref_bits(r))
    assert tree.structure(pst) == tree.structure(st)
    # the port reads a state's own Python and 64-bit leaves as the reference does
    limbs, meta = prs.state_to_limbs(st, "cpu")
    assert np.array_equal(to_numpy(limbs), np.asarray(rrs.state_to_limbs(st)[0]))
    assert [str(d).replace("torch.", "") for d in meta.dtypes] == [ref_dtype(r) for r in jax.tree.leaves(st)]
    with pytest.raises(OverflowError):
        prs.state_to_limbs({"big": 1 << 40}, "cpu")


@pytest.mark.parametrize("K", [3, 4, 8])
def test_shard_unshard_equal_reference(K):
    st = mixed_state(K)
    r_sh, r_meta = rrs.shard_state_limbs(st, K)
    sh, meta = prs.shard_state_limbs(state_from_reference(st, "cpu"), K, "cpu")
    assert tuple(sh.shape) == tuple(r_sh.shape)
    assert np.array_equal(to_numpy(sh), np.asarray(r_sh))
    back = prs.unshard_state_limbs(sh, meta)
    for a, r in zip(tree.leaves(back), jax.tree.leaves(st)):
        assert np.array_equal(bits(a), ref_bits(r))


# ---------------------------------------------------------------------------
# parity and recovery
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("K", [4, 8, 16])
def test_parity_plan_and_encode_equal_reference(K):
    r_plan, plan = rrs.build_parity_plan(K), prs.build_parity_plan(K)
    assert plans_equal(plan, r_plan)
    assert (plan.c1, plan.c2) == (r_plan.c1, r_plan.c2)
    assert plans_equal(from_reference(r_plan), plan)
    x = np.random.default_rng(K).integers(0, 1 << 16, size=(K, 37), dtype=np.uint32)
    want = encode_oracle(x, r_plan.A, r_plan.q)
    if K == 4:  # the reference's own encode, once (see the module's docstring)
        assert np.array_equal(np.asarray(rrs.encode_parity(jnp.asarray(x), r_plan)), want)
    got = prs.encode_parity(t32(x), plan)
    assert got.device.type == "cpu"
    assert np.array_equal(to_numpy(got), want)
    assert np.array_equal(to_numpy(prs.encode_parity(t32(x), from_reference(r_plan))), want)


@pytest.mark.parametrize("K,f_lost", [(4, 1), (8, 2), (8, 3), (16, 5)])
def test_recover_lost_equal_reference_and_bit_exact(K, f_lost):
    """Kill f replicas; the port's recovery equals the reference's and the
    whole float state reassembles bit for bit."""
    rng = np.random.default_rng(K)
    st = {
        "params": rng.normal(size=(K * 37,)).astype(np.float32),
        "m": rng.normal(size=(K * 13,)).astype(np.float32),
        "step": np.int32(123),
    }
    r_sh, _ = rrs.shard_state_limbs(st, K)
    r_plan = rrs.build_parity_plan(K)
    r_sn = np.asarray(r_sh, dtype=np.uint64)
    r_par = encode_oracle(r_sn, r_plan.A, r_plan.q)

    sh, meta = prs.shard_state_limbs(state_from_reference(st, "cpu"), K, "cpu")
    plan = prs.build_parity_plan(K)
    sn, par = to_numpy(sh), to_numpy(prs.encode_parity(sh, plan))
    assert np.array_equal(par, r_par)

    lost = [int(k) for k in rng.choice(K, size=f_lost, replace=False)]
    rec = prs.recover_lost(plan, lost, {k: sn[k] for k in range(K) if k not in lost},
                           {k: par[k] for k in range(K) if k not in lost})
    r_rec = rrs.recover_lost(r_plan, lost, {k: r_sn[k] for k in range(K) if k not in lost},
                             {k: r_par[k] for k in range(K) if k not in lost})
    full = sn.copy()
    for k in lost:
        assert np.array_equal(rec[k], r_rec[k])
        assert np.array_equal(rec[k], sn[k])
        full[k] = rec[k]
    back = prs.unshard_state_limbs(t32(full), meta)
    for name in st:
        assert np.array_equal(bits(back[name]), ref_bits(st[name]))


def test_recover_lost_needs_enough_parity():
    plan = prs.build_parity_plan(4)
    x = np.zeros((4, 3), np.uint32)
    with pytest.raises(ValueError, match="need ≥3 surviving parity"):
        prs.recover_lost(plan, [0, 1, 2], {3: x[3]}, {3: x[3], 2: x[2]})


@pytest.mark.parametrize("sizes", [None, (8,), (2, 4), (4, 2), (2, 2, 2)])
def test_collective_forms_equal_reference_encode(sizes):
    K = 8
    r_plan, plan = rrs.build_parity_plan(K), prs.build_parity_plan(K)
    x = np.random.default_rng(5).integers(0, 1 << 16, size=(K, 29), dtype=np.uint32)
    fn = prs.encode_parity_collective(plan, sizes, device="cpu")
    assert fn.device.type == "cpu"
    assert np.array_equal(to_numpy(fn(t32(x))), encode_oracle(x, r_plan.A, r_plan.q))


def test_collective_sizes_must_hold_k():
    with pytest.raises(ValueError, match="sizes"):
        prs.encode_parity_collective(prs.build_parity_plan(8), (3, 2), device="cpu")


def test_collective_forms_equal_reference_mesh_runs(tmp_path):
    """8 forced host devices: the reference's ``encode_parity_collective``
    on a flat 8-wide axis, a 2×4 mesh and a 2×2×2 mesh, and its
    ``lcc_encode_collective`` on an 8-wide axis; the port's one-device
    forms must equal every output."""
    out_file = tmp_path / "ref.npz"
    code = f"""
        import numpy as np, jax.numpy as jnp
        from repro.launch.mesh import make_mesh
        from repro.coded.rs_checkpoint import build_parity_plan, encode_parity_collective
        from repro.coded.lagrange_compute import build_lcc, lcc_encode_collective, lcc_pad
        plan = build_parity_plan(8)
        x = jnp.asarray(np.random.default_rng(11).integers(0, 1 << 16, size=(8, 24), dtype=np.uint32))
        res = {{}}
        res["flat"] = np.asarray(encode_parity_collective(make_mesh((8,), ("dp",)), "dp", plan)(x))
        res["two"] = np.asarray(encode_parity_collective(
            make_mesh((2, 4), ("inter", "intra")), ("inter", "intra"), plan)(x))
        res["three"] = np.asarray(encode_parity_collective(
            make_mesh((2, 2, 2), ("a", "b", "c")), ("a", "b", "c"), plan)(x))
        lplan = build_lcc(6, R=2)
        X = jnp.asarray(np.random.default_rng(12).integers(0, 1 << 16, size=(6, 10), dtype=np.uint32))
        res["lcc"] = np.asarray(lcc_encode_collective(make_mesh((8,), ("hosts",)), "hosts", lplan)(lcc_pad(lplan, X)))
        np.savez({str(out_file)!r}, **res)
        print("reference mesh runs ok")
    """
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], capture_output=True, text=True,
                       env=env, timeout=600)
    assert r.returncode == 0, f"child failed:\nSTDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    ref = np.load(out_file)
    plan = prs.build_parity_plan(8)
    x = t32(np.random.default_rng(11).integers(0, 1 << 16, size=(8, 24), dtype=np.uint32))
    single = to_numpy(prs.encode_parity(x, plan))
    for key, sizes in (("flat", None), ("two", (2, 4)), ("three", (2, 2, 2))):
        got = to_numpy(prs.encode_parity_collective(plan, sizes, device="cpu")(x))
        assert np.array_equal(got, ref[key]), key
        assert np.array_equal(got, single), key
    lplan = plc.build_lcc(6, R=2)
    X = t32(np.random.default_rng(12).integers(0, 1 << 16, size=(6, 10), dtype=np.uint32))
    got = to_numpy(plc.lcc_encode_collective(lplan, device="cpu")(plc.lcc_pad(lplan, X)))
    assert np.array_equal(got, ref["lcc"])
    assert np.array_equal(got, to_numpy(plc.lcc_encode(lplan, X)))


# ---------------------------------------------------------------------------
# Lagrange coded computing
# ---------------------------------------------------------------------------


LCC_CASES = [(K, q, R) for K in (4, 8) for q in (M31, NTT) for R in (0, 2)] + [(12, NTT, 0)]


@pytest.mark.parametrize("K,q,R", LCC_CASES)
def test_lcc_plan_generator_encode_decode_equal_reference(K, q, R):
    r_plan, plan = rlc.build_lcc(K, q=q, R=R), plc.build_lcc(K, q=q, R=R)
    assert plans_equal(plan, r_plan)
    assert plans_equal(from_reference(r_plan), plan)
    assert plan.N == K + R
    assert np.array_equal(plc.lcc_generator(plan), rlc.lcc_generator(r_plan))
    rng = np.random.default_rng(K * 17 + R + (q & 0xFF))
    X = rng.integers(0, q, size=(K, 7, 3), dtype=np.uint64)
    padded = np.concatenate([X, np.zeros((R, 7, 3), np.uint64)])
    want = encode_oracle(padded, rlc.lcc_generator(r_plan), q)
    if (K, q, R) in ((4, M31, 2), (12, NTT, 0)):  # the reference's own encodes, once a kind
        assert np.array_equal(np.asarray(rlc.lcc_encode(r_plan, jnp.asarray(X.astype(np.uint32)))), want)
    got = plc.lcc_encode(plan, t32(X))
    assert got.device.type == "cpu" and tuple(got.shape) == (K + R, 7, 3)
    assert np.array_equal(to_numpy(got), want)
    coded = want.astype(np.uint64)
    for _ in range(3):
        survivors = sorted(int(r) for r in rng.choice(K + R, size=K, replace=False))
        dec = plc.lcc_decode(plan, coded[survivors], survivors)
        assert np.array_equal(dec, rlc.lcc_decode(r_plan, coded[survivors], survivors))
        assert np.array_equal(dec, X)
    if R:
        fn = plc.lcc_encode_collective(plan, device="cpu")
        assert np.array_equal(to_numpy(fn(plc.lcc_pad(plan, t32(X)))), want)


@pytest.mark.parametrize("q", [M31, NTT])
def test_lcc_compute_and_decode_equal_reference(q):
    K, R = 4, 3
    f = Field(q)
    rng = np.random.default_rng(3)
    r_plan, plan = rlc.build_lcc(K, q=q, R=R), plc.build_lcc(K, q=q, R=R)
    X = rng.integers(0, 1 << 20, size=(K, 5, 3), dtype=np.uint64)
    W = rng.integers(0, 1 << 20, size=(3, 2), dtype=np.uint64)
    encoded = to_numpy(plc.lcc_encode(plan, t32(X))).astype(np.uint64)
    for responders in ([0, 1, 2, 3], [3, 4, 5, 6], [6, 0, 5, 2]):
        out = plc.lcc_compute_and_decode(plan, encoded, W, responders)
        assert np.array_equal(out, rlc.lcc_compute_and_decode(r_plan, encoded, W, responders))
        for i in range(K):
            assert np.array_equal(out[i], f.matmul(X[i] % q, W % q))


def test_lcc_zero_size_payload():
    K, R = 4, 2
    plan = plc.build_lcc(K, R=R)
    coded = plc.lcc_encode(plan, t32(np.zeros((K, 0))))
    assert tuple(coded.shape) == (K + R, 0)
    got = plc.lcc_decode(plan, to_numpy(coded)[:K], list(range(K)))
    assert got.shape == (K, 0)
    sq = plc.lcc_encode(plc.build_lcc(K), t32(np.zeros((K, 0))))
    assert tuple(sq.shape) == (K, 0)
    # an empty pytree shards into (K, 0) limbs and encodes to (K, 0) parity
    sh, meta = prs.shard_state_limbs({}, 4, "cpu")
    assert tuple(sh.shape) == (4, 0) and meta.total == 0
    assert tuple(prs.encode_parity(sh, prs.build_parity_plan(4)).shape) == (4, 0)
    assert prs.unshard_state_limbs(sh, meta) == {}


def test_lcc_error_paths_raise_like_the_reference():
    """K−1 responders, duplicates, out-of-range indices, a negative R and a
    wrong row count raise ValueError with the reference's messages."""
    K, R = 4, 2
    plan = plc.build_lcc(K, R=R)
    coded = to_numpy(plc.lcc_encode(plan, t32(np.arange(K * 6).reshape(K, 6)))).astype(np.uint64)
    with pytest.raises(ValueError, match="need ≥4 responders"):
        plc.lcc_decode(plan, coded[: K - 1], list(range(K - 1)))
    with pytest.raises(ValueError, match="duplicate"):
        plc.lcc_decode(plan, coded[[0, 0, 1, 2]], [0, 0, 1, 2])
    with pytest.raises(ValueError, match="outside"):
        plc.lcc_decode(plan, coded[:K], [0, 1, 2, K + R])
    with pytest.raises(ValueError):
        plc.build_lcc(K, R=-1)
    with pytest.raises(ValueError, match="K=4 rows"):
        plc.lcc_pad(plan, t32(np.zeros((K + 1, 3))))


# ---------------------------------------------------------------------------
# gradient coding (float32: rtol 1e-6)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("K,s", [(5, 1), (8, 2), (12, 3)])
def test_gradient_coding_equal_reference(K, s):
    r_plan, plan = rgc.build_grad_coding(K, s, seed=1), pgc.build_grad_coding(K, s, seed=1)
    assert np.array_equal(plan.B, r_plan.B) and plan.r == r_plan.r
    assert plans_equal(from_reference(r_plan), plan)
    rng = np.random.default_rng(0)
    grads = {j: {"w": rng.normal(size=(4, 3)).astype(np.float32),
                 "b": [rng.normal(size=(5,)).astype(np.float32)]} for j in range(K)}
    p_grads = {j: state_from_reference(g, "cpu") for j, g in grads.items()}
    want = sum(grads[j]["w"] for j in range(K))
    sent = {i: pgc.worker_combine(plan, i, p_grads) for i in range(K)}
    r_grads = {j: jax.tree.map(jnp.asarray, g) for j, g in grads.items()}  # float32 on the JAX side
    r_sent = {i: rgc.worker_combine(r_plan, i, r_grads) for i in range(K)}
    for i in range(K):
        for a, r in zip(tree.leaves(sent[i]), jax.tree.leaves(r_sent[i])):
            assert a.dtype == torch.float32
            np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=1e-6, atol=0)
    for drop_seed in range(3):
        drop = set(np.random.default_rng(drop_seed).choice(K, size=s, replace=False).tolist())
        got = pgc.aggregate(plan, {i: c for i, c in sent.items() if i not in drop})
        r_got = rgc.aggregate(r_plan, {i: c for i, c in r_sent.items() if i not in drop})
        np.testing.assert_allclose(got["w"].numpy(), np.asarray(r_got["w"]), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got["w"].numpy(), want, rtol=1e-4, atol=1e-4)
    survivors = list(range(s, K))
    np.testing.assert_array_equal(pgc.decode_vector(plan, survivors), rgc.decode_vector(r_plan, survivors))


def test_gradient_coding_too_many_stragglers_raises():
    plan = pgc.build_grad_coding(6, 1, seed=1)
    with pytest.raises(RuntimeError, match="cannot decode"):
        pgc.decode_vector(plan, [0, 2, 4])


def test_coded_package_exports_the_reference_list():
    import repro.coded as rcoded

    want = sorted(n for n in dir(rcoded) if not n.startswith("_") and callable(getattr(rcoded, n)))
    got = sorted(n for n in dir(pcoded) if not n.startswith("_") and callable(getattr(pcoded, n)))
    assert got == want
