"""The recurrent (RWKV6, Jamba), encoder-decoder (Whisper) and VLM (InternVL2)
families on a mesh of ranks against the reference, on a (data=2, model=2)
mesh of four gloo ranks on the CPU.

The port draws the float32 inputs (``torch_mesh_ssm_harness.write_inputs``:
weights from seed 0, a seeded batch); then one JAX child with 8 forced host
devices writes the launchers' checkpoints and the reference's outputs
(``torch_mesh_ssm_harness.reference_main``) while one 4-rank world runs
every port case beside it (``torch_mesh_ssm_harness.port_main``, deadline
``DEADLINE_S``: 5.3x the 113.5 s the world took alone on an 8-core CPU
machine with no other load, the child run first, 172.7 s); the tests below
assert on the results. The sharding specs
of the four models at full width are compared leaf by leaf on a mesh made by
hand (only its axis names and sizes are read), under ``train_4k``,
``decode_32k`` and ``long_500k`` with the baseline and ``opt`` profiles.
The float32 smoke configs run with the same weights on both sides (Jamba at
one period of 8 layers: Mamba, Mamba-MoE and its attention layer).

Tolerances:

* the forward logits under the training rules (sequence over ``model``)
  against the reference's one-process logits: ``LOGITS_ATOL`` (1e-4)
  absolute, ``tests/test_torch_ssm.py``'s float32 logits tolerance;
* the train step at ``tests/test_torch_train.py``'s float32 tolerances:
  loss ``LOSS_ATOL`` (1e-5), global norm relative ``NORM_RTOL`` (1e-5), each
  parameter within 2 · lr · ``STEP_SLACK`` plus ``STEP_TIGHT`` of the
  reference's, at most ``STEP_FRACTION`` of a leaf's elements beyond
  ``STEP_TIGHT``;
* the fixed engine's greedy tokens on the mesh (baseline and ``opt``
  rules) and the serving launcher's token lines: equal to the reference's;
* a refeed of 8 seeded ticks through the meshed decode step: every tick's
  logits within ``LOGITS_ATOL`` of the reference's, the decode state after
  it (Mamba's ``h`` and conv tails, RWKV6's ``wkv`` and token-shift rows,
  the attention layers' K/V, Whisper's ``enc_out``) within ``STATE_ATOL``
  (1e-5), ``tests/test_torch_ssm.py``'s float32 module tolerance;
* ``Model.init(generator, shardings=)`` against ``place(model.init(generator),
  shardings)``: bit for bit;
* the coded shards of the rank form ``CodedServeGuard(mesh=, axis=)`` over
  the meshed recurrent state: equal to the reference guard's over the same
  (gathered) state, and its recovery bit for bit;
* the training launcher with ``--mesh 2x2 --coded-every 1``, resuming from
  a checkpoint of the reference's bf16 smoke weights: the loss and gradient
  norm it prints within ``LAUNCH_LOSS_ATOL`` (2e-3) and ``LAUNCH_NORM_RTOL``
  (5e-3, relative) of the reference launcher's (RWKV6, Jamba: the
  reference's launcher feeds no frames or patches) and of the same run in
  one process (all four): bf16 weights and activations summed in another
  order, about ten times the 2e-4 and 7e-4 seen; its parity equal to a
  one-process guard's over the gathered state;
* the serving launcher's bf16 token lines: equal to the reference's up to a
  position where the one-process logits tie at the top (both picks then
  among the tied tokens; see that test).
"""

import functools
import json

import jax  # noqa: F401 - both packages in one test process, JAX on the CPU
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate

import torch_mesh_ssm_harness as H
from repro.configs import SHAPES as R_SHAPES
from repro.serve import CodedServeGuard as RCodedServeGuard
from repro_torch import tree
from repro_torch.configs import SHAPES, get
from repro_torch.launch.mesh import RankMesh
from repro_torch.launch.profiles import BASELINE, OPT, rules_for
from repro_torch.models import build_model
from repro_torch.train import OptConfig
from repro_torch.train.train_loop import batch_shardings, cache_shardings, opt_state_shardings, param_shardings
from torch_ranks_harness import run_ranks

LOGITS_ATOL, STATE_ATOL = 1e-4, 1e-5
LOSS_ATOL, NORM_RTOL = 1e-5, 1e-5
STEP_SLACK, STEP_TIGHT, STEP_FRACTION = 1.05, 1e-6, 0.02
LAUNCH_LOSS_ATOL, LAUNCH_NORM_RTOL = 2e-3, 5e-3
DEADLINE_S = 600.0

PROFILES = {"baseline": BASELINE, "opt": OPT}
CASES = [f"{a}/{s}/{p}" for a, s, p in H.SPEC_CASES]
RUNS = [f"{a}/{p}" for a in H.ARCHS for p in H.PROFILES]


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """(the reference's outputs, the port's results), the JAX child and the
    4-rank world run side by side on the same inputs."""
    d = str(tmp_path_factory.mktemp("mesh_ssm"))
    inputs = H.write_inputs(d)
    child = H.start_reference(inputs, d)
    try:
        port = run_ranks(4, "torch_mesh_ssm_harness:port_main", inputs, d, deadline=DEADLINE_S)
    finally:
        path = H.reference_outputs(child)
    data = dict(np.load(path))
    return {"data": data, "specs": json.loads(str(data["specs"]))}, port


@pytest.fixture(scope="module")
def ref(both):
    return both[0]


@pytest.fixture(scope="module")
def port(both):
    return both[1]


def hand_mesh():
    return RankMesh(None, H.MESH[0], H.MESH[1], 0, (0, 0), (0, 1, 2, 3), torch.device("cpu"))


def as_json(spec):
    return json.loads(json.dumps([None if e is None else e if isinstance(e, str) else list(e) for e in spec]))


@functools.lru_cache(maxsize=4)
def full_model(arch):
    return build_model(get(arch))


def case(c):
    arch, shape, prof = c.split("/")
    return full_model(arch), rules_for(get(arch), SHAPES[shape], PROFILES[prof]), SHAPES[shape]


# ---------------------------------------------------------------------------
# the sharding functions at full width, leaf by leaf against the reference's specs
# ---------------------------------------------------------------------------


def test_the_cases_cover_the_reference_shapes_and_the_four_families():
    assert all(s in R_SHAPES for _, s, _ in H.SPEC_CASES)
    assert {a for a, _, _ in H.SPEC_CASES} == set(H.ARCHS)
    fam = [(get(a).ssm and get(a).ssm.kind, get(a).encdec is not None, get(a).vlm is not None) for a in H.ARCHS]
    assert fam == [("rwkv6", False, False), ("mamba", False, False), (None, True, False), (None, False, True)]


@pytest.mark.parametrize("c", CASES)
def test_param_shardings_equal_the_reference(ref, c):
    model, rules, _ = case(c)
    got = [as_json(s.spec) for s in tree.leaves(param_shardings(model, hand_mesh(), rules))]
    assert got == ref["specs"][c + "/params"]


@pytest.mark.parametrize("c", CASES)
def test_opt_state_shardings_equal_the_reference(ref, c):
    model, rules, _ = case(c)
    ost = opt_state_shardings(OptConfig(), model, hand_mesh(), rules)
    assert [as_json(s.spec) for s in tree.leaves(ost)] == ref["specs"][c + "/opt"]
    assert ost["step"].spec == () and all(isinstance(p, Replicate) for p in ost["step"].placements)


@pytest.mark.parametrize("c", CASES)
def test_batch_shardings_equal_the_reference(ref, c):
    """Frames and patches too: by the reference's ``batch_dims``."""
    model, rules, shape = case(c)
    kind = "decode" if shape.kind == "decode" else "train"
    got = {k: as_json(v.spec) for k, v in batch_shardings(model, hand_mesh(), rules, kind).items()}
    assert got == ref["specs"][c + "/batch"]


@pytest.mark.parametrize("c", CASES)
def test_cache_shardings_equal_the_reference(ref, c):
    model, rules, _ = case(c)
    cache = model.init_cache(*H.CACHE, device="meta")
    got = [as_json(s.spec) for s in tree.leaves(cache_shardings(model, hand_mesh(), rules, cache))]
    assert got == ref["specs"][c + "/cache"]


def test_the_recurrent_leaves_are_split_as_the_reference_splits_them(ref):
    """Mamba's d_inner and RWKV6's heads lie over ``model``; the state's
    ``state`` and ``conv`` dims stay whole; batch over ``data``."""
    def leaf(c, *path):
        model, rules, _ = case(c)
        t = param_shardings(model, hand_mesh(), rules)
        for k in path:
            t = t[k]
        return t.spec

    def cache(c, *path):
        model, rules, _ = case(c)
        t = cache_shardings(model, hand_mesh(), rules, model.init_cache(*H.CACHE, device="meta"))
        for k in path:
            t = t[k]
        return t

    # Jamba (52B) keeps FSDP's d_model over data under opt; RWKV6-3B fits without it
    assert leaf("jamba-v0.1-52b/decode_32k/opt", "body", "b0", "mamba", "in_proj") == (None, "data", "model")
    assert leaf("jamba-v0.1-52b/decode_32k/opt", "body", "b0", "mamba", "x_proj") == (None, "model", None)
    assert leaf("rwkv6-3b/decode_32k/opt", "body", "b0", "tm", "wr") == (None, None, "model")
    assert leaf("rwkv6-3b/decode_32k/opt", "body", "b0", "tm", "wo") == (None, "model", None)
    h, tail = cache("jamba-v0.1-52b/decode_32k/baseline", "body", "b0")
    assert h.spec == (None, "data", "model", None) and tail.spec == (None, "data", None, "model")
    assert cache("rwkv6-3b/decode_32k/baseline", "body", "b0", "wkv").spec == (None, "data", "model", None, None)


# ---------------------------------------------------------------------------
# the 4-rank world: the sharded draw
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", H.ARCHS)
@pytest.mark.parametrize("prof", H.PROFILES)
@pytest.mark.parametrize("slabs", [False, True], ids=["whole", "slabs"])
def test_sharded_init_equals_placing_the_whole_draw(port, arch, prof, slabs):
    """The SSM leaves numpy makes (``A_log``, ``dt_proj_b``, ``D``, ``w0``),
    the encoder's stacked layers and cross blocks: each rank keeps its block
    of every slab, the same bits as the whole draw placed."""
    from repro_torch.models import layers as L

    slab = 64 * 32 if slabs else L.SLAB_ELEMENTS
    assert port[0]["init"][f"{arch}/{prof}/{slab}"]


# ---------------------------------------------------------------------------
# the forward and one train step on the mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("run", RUNS)
def test_meshed_forward_equals_the_reference(ref, port, run):
    arch, _ = run.split("/")
    got = port[0]["forward"][run]
    assert got["placed"]
    want = ref["data"][f"logits/{arch}"]
    assert got["logits"].shape == want.shape
    np.testing.assert_allclose(got["logits"], want, rtol=0, atol=LOGITS_ATOL)


@pytest.mark.parametrize("arch", H.ARCHS)
def test_meshed_forward_of_a_plain_batch_equals_the_reference(ref, port, arch):
    """A batch of plain tensors (what a prefill step gets: frames and
    patches too) is every rank's whole on the meshed weights."""
    got = port[0]["forward"][f"{arch}/plain_batch"]
    assert got["placed"]
    np.testing.assert_allclose(got["logits"], ref["data"][f"logits/{arch}"], rtol=0, atol=LOGITS_ATOL)


@pytest.mark.parametrize("run", RUNS)
def test_train_step_on_the_mesh_equals_the_reference(ref, port, run):
    arch, _ = run.split("/")
    st, d, pre = port[0]["train"][run], ref["data"], f"step/{arch}"
    assert st["kept"]
    for k in ("loss", "ce", "aux"):
        assert abs(st["metrics"][k] - float(d[f"{pre}/{k}"])) <= LOSS_ATOL, k
    np.testing.assert_allclose(st["metrics"]["grad_norm"], float(d[f"{pre}/grad_norm"]), rtol=NORM_RTOL)
    lr = st["metrics"]["lr"]
    assert lr == pytest.approx(float(d[f"{pre}/lr"]), rel=1e-6)
    for i, a in enumerate(st["params"]):
        diff = np.abs(a - d[f"{pre}/params/{i}"])
        assert diff.max() <= 2 * lr * STEP_SLACK + STEP_TIGHT, i
        assert (diff > STEP_TIGHT).mean() <= STEP_FRACTION, i


# ---------------------------------------------------------------------------
# serving: the fixed engine, the refeed's state, the guard
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("run", RUNS)
def test_fixed_engine_2x2_tokens_equal_the_reference(ref, port, run):
    arch, _ = run.split("/")
    want = [ref["data"][f"tokens/{arch}/{i}"].tolist() for i in range(len(H.PROMPTS))]
    assert port[0]["engine"][run] == want
    assert port[0]["engine"][run + "/placed"]
    assert all(r["engine"] == port[0]["engine"] for r in port)


@pytest.mark.parametrize("arch", H.ARCHS)
def test_refeed_state_on_the_mesh_equals_the_reference(ref, port, arch):
    got, d = port[0]["refeed"][arch], ref["data"]
    assert got["in_place"]  # every tick wrote each rank's own blocks of the cache it was given
    for t, lg in enumerate(got["logits"]):
        np.testing.assert_allclose(lg, d[f"refeed/{arch}/logits/{t}"], rtol=0, atol=LOGITS_ATOL)
    for i, leaf in enumerate(got["cache"]):
        want = d[f"refeed/{arch}/cache/{i}"]
        assert leaf.shape == want.shape and leaf.dtype == want.dtype, i
        np.testing.assert_allclose(leaf, want, rtol=0, atol=STATE_ATOL, err_msg=str(i))
    assert all("Shard" in p for p in got["placed"])


@pytest.mark.parametrize("arch", H.RECURRENT)
def test_rank_form_guard_shards_of_the_meshed_recurrent_state_equal_the_reference(port, arch):
    """``CodedServeGuard(K=2, R=2, mesh=<the four ranks as hosts>)`` over the
    meshed recurrent cache and ``{"tokens", "pos"}``: its coded shards equal
    the reference guard's over the same state, leaf for leaf in the
    reference's order; host 3 killed, the recovery is the snapshot's bits."""
    g = port[0]["guard"][arch]
    leaves = g["leaves"]
    n_state = 2  # the state's "pos", "tokens" (sorted keys), after the cache's leaves
    rg = RCodedServeGuard(K=H.RANK_K, R=H.RANK_R)
    rg.snapshot([jnp.asarray(x) for x in leaves[:-n_state]], [jnp.asarray(x) for x in leaves[-n_state:]], tick=0)
    assert g["rows"].shape[0] == H.RANK_K + H.RANK_R
    for j in range(H.RANK_K + H.RANK_R):
        np.testing.assert_array_equal(g["rows"][j], np.asarray(rg.group._mem[j]))
    assert g["bit_exact"]
    assert all(r["guard"][arch]["dead"] == [H.RANK_KILL] and r["guard"][arch]["alive"] == [0, 1, 2] for r in port)


@pytest.mark.parametrize("arch", H.ARCHS)
@pytest.mark.parametrize("where", ["mesh", "one"])
def test_continuous_engine_refuses_a_model_with_no_one_pass_prefill(port, arch, where):
    """On a mesh with the message of one process: these families serve
    through the fixed engine."""
    msg = port[0]["continuous"][f"{arch}/{where}"]
    assert msg == port[0]["continuous"][f"{arch}/one"] and "one-pass prefill" in msg and arch in msg
    assert all(r["continuous"] == port[0]["continuous"] for r in port)


@pytest.mark.parametrize("arch", H.ARCHS)
def test_serve_launcher_2x2_refuses_coded_without_the_continuous_engine(port, arch):
    assert port[0]["coded_refused"][arch] == "--coded needs the continuous engine"


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------


def rows_of(lines) -> list:
    return [json.loads(s.split(": ", 1)[1]) for s in lines if s.startswith("seq ")]


@pytest.mark.parametrize("arch", H.ARCHS)
def test_serve_launcher_2x2_prints_the_reference_lines(ref, port, arch):
    """The fall-back line, and the token lines up to a tie: the bf16 smoke
    weights tie two logits at the top now and then (as the reference's own
    runs do on another mesh), and greedy picks either. Each row of the
    meshed launcher and of the reference's equals the one-process refeed's
    until a position where the one-process logits tie at the top; there
    both picks are among the tied tokens, and the rows are not compared
    past it."""
    want = json.loads(str(ref["data"][f"launch/{arch}"]))
    got = port[0]["launch"][arch]
    fall = f"{arch}-smoke: no one-pass prefill; falling back to fixed-batch"
    assert want[0] == fall and got["printed"][0] == fall
    mesh_rows, ref_rows, one = rows_of(got["printed"]), rows_of(want), got["one"]
    assert len(mesh_rows) == len(ref_rows) == len(one) == 2
    for b, (m, r, o) in enumerate(zip(mesh_rows, ref_rows, one)):
        assert len(m) == len(r) == len(o)
        for pos in range(len(o)):
            if m[pos] == r[pos] == o[pos]:
                continue
            tied = got["ties"][b].get(pos, [])
            assert len(tied) > 1 and {m[pos], r[pos], o[pos]} <= set(tied), (b, pos, m, r, o, tied)
            break


@pytest.mark.parametrize("arch", H.ARCHS)
def test_train_launcher_2x2_with_coded_every_resumes_and_trains(ref, port, arch):
    tl = port[0]["train_launch"][arch]
    assert tl["start"] == H.TRAIN_CKPT_STEP and tl["placed"] and tl["held"] and tl["step"] == 1
    assert tl["one_guard_equal"]
    assert tl["printed"][0] == f"restored checkpoint at step {H.TRAIN_CKPT_STEP}"
    (h,), (o,) = tl["history"], tl["one_history"]
    assert abs(h["loss"] - o["loss"]) <= LAUNCH_LOSS_ATOL and abs(h["grad_norm"] / o["grad_norm"] - 1) <= LAUNCH_NORM_RTOL
    numbers = lambda hist: [(h["step"], h["loss"], h["grad_norm"]) for h in hist]  # noqa: E731 - not the wall seconds
    assert all(numbers(r["train_launch"][arch]["history"]) == numbers(tl["history"]) for r in port)
    if arch in H.RECURRENT:
        want = json.loads(str(ref["data"][f"train_launch/{arch}"]))
        assert want[0] == tl["printed"][0]
        s, loss, gnorm = H.parse_step_line(next(x for x in want if x.startswith("step")))
        s2, loss2, gnorm2 = H.parse_step_line(next(x for x in tl["printed"] if x.startswith("step")))
        assert s == s2 == H.TRAIN_CKPT_STEP
        assert abs(loss - loss2) <= LAUNCH_LOSS_ATOL and abs(gnorm2 / gnorm - 1) <= LAUNCH_NORM_RTOL
