"""The reference's side and the port's side of ``tests/test_torch_mesh_ssm.py``.

:func:`reference_outputs` runs :func:`reference_main` in one JAX child with
8 forced host devices: the reference's sharding specs (``param_shardings``,
``opt_state_shardings``, ``batch_shardings``, ``cache_shardings`` on a
(data=2, model=2) mesh) for RWKV6-3B, Jamba, Whisper-base and InternVL2-26B
at full width under three shapes and two profiles; for each float32 smoke
config (Jamba at one period of 8 layers) its forward logits and one train
step on a seeded batch, its fixed engine's greedy tokens, and a refeed of
seeded tokens through its decode step (the decode state and the logits of
every tick; Whisper attends the encoding of seeded frames); and its serving
and training launchers with ``--mesh 2x2`` on its checkpoints (its
training launcher feeds tokens alone, so it runs the recurrent families
only). Its outputs go to an ``.npz``, the specs as JSON. :func:`port_main` is the port's side, run on
every rank of one 4-rank gloo world (``torch_ranks_harness.run_ranks``)
over the same inputs. Nothing here imports JAX outside the child.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys

import numpy as np

from torch_mesh_moe_harness import _leaves_from, _numpy

MESH = ((2, 2), ("data", "model"))
ARCHS = ("rwkv6-3b", "jamba-v0.1-52b", "whisper-base", "internvl2-26b")
RECURRENT = ARCHS[:2]
SHAPES = ("train_4k", "decode_32k", "long_500k")
PROFILES = ("baseline", "opt")
SPEC_CASES = [(a, s, p) for a in ARCHS for s in SHAPES for p in PROFILES]
CACHE = (4, 64)  # the cache whose shardings are compared: slots, positions
BATCH = (4, 16, 5)  # the forward's and the train step's batch, sequence (patches included), seed
OPT_CFG = dict(lr=1e-3, warmup_steps=1, total_steps=10)
PROMPTS = [[5, 9, 2, 7, 1], [3, 3, 8], [11, 4, 6, 2, 9, 10, 1], [2]]
MAX_NEW, MAX_LEN = 6, 32
SERVE_SHAPE = ("serve-test", "decode", MAX_LEN, 4)
REFEED = (4, 8, 11)  # the refeed's rows, ticks, seed of its tokens and of Whisper's frames
RANK_K, RANK_R, RANK_KILL = 2, 2, 3  # the rank form over the four ranks as hosts; host 3 dies
LAUNCH_PROMPTS = "1,2,3;7,8"
LAUNCH_NEW, LAUNCH_MAX_LEN = 6, 128  # the serving launcher's budget and its default max_len
TRAIN_ARGV = ["--smoke", "--mesh", "2x2", "--steps", "2", "--batch", "4", "--seq", "16", "--coded-every", "1"]
TRAIN_CKPT_STEP = 1  # the launchers resume from this step's checkpoint and run one step
CKPT_READY = "checkpoints_written"  # the child's mark that the launchers' checkpoints are on disk
CKPT_WAIT_S = 600.0


def small_config(smoke_config, arch: str, dtype: str = "float32"):
    """``arch``'s smoke config in ``dtype``; Jamba at one period of 8 layers
    (its Mamba, Mamba-MoE and attention layers)."""
    cfg = smoke_config(arch).replace(dtype=dtype)
    return cfg.replace(n_layers=8) if arch == "jamba-v0.1-52b" else cfg


def _spec(s) -> list:
    """A PartitionSpec (or the port's tuple) as JSON: entries None, a name or
    a list of names."""
    return [None if e is None else e if isinstance(e, str) else list(e) for e in tuple(s)]


def _repo() -> str:
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def serve_argv(arch: str, ckpt: str) -> list:
    return ["--arch", arch, "--smoke", "--mesh", "2x2", "--prompts", LAUNCH_PROMPTS, "--max-new", str(LAUNCH_NEW),
            "--max-len", str(LAUNCH_MAX_LEN), "--ckpt", ckpt]


def refeed_tokens(vocab: int) -> np.ndarray:
    B, T, seed = REFEED
    return np.random.default_rng(seed).integers(0, vocab, size=(B, T)).astype(np.int32)


def refeed_frames(cfg) -> np.ndarray:
    B, _, seed = REFEED
    return (np.random.default_rng(seed + 1).normal(size=(B, cfg.encdec.n_frames, cfg.d_model)) * 0.5).astype(
        np.float32)


def make_inputs(cfg) -> dict:
    """The forward's and the train step's batch, drawn with numpy: tokens
    and labels, and the stub frontend's float32 frames or patches (the
    sequence counts the patches, as ``models.inputs`` counts them)."""
    B, S, seed = BATCH
    rng = np.random.default_rng(seed)
    text = S - (cfg.vlm.n_patches if cfg.vlm else 0)
    tokens = rng.integers(0, cfg.vocab_size, size=(B, text)).astype(np.int32)
    out = {"tokens": tokens, "labels": tokens.copy()}
    if cfg.encdec is not None:
        out["frames"] = (rng.normal(size=(B, cfg.encdec.n_frames, cfg.d_model)) * 0.02).astype(np.float32)
    if cfg.vlm is not None:
        out["patches"] = (rng.normal(size=(B, cfg.vlm.n_patches, cfg.d_model)) * 0.02).astype(np.float32)
    return out


def write_inputs(tmp_dir: str) -> str:
    """The float32 inputs both sides read, drawn by the port on the CPU:
    each smoke config's weights from seed 0 and its batch, into an ``.npz``
    under ``tmp_dir``, whose path is returned."""
    import torch

    from repro_torch import tree
    from repro_torch.configs import smoke_config
    from repro_torch.models import build_model

    out = {}
    for arch in ARCHS:
        cfg = small_config(smoke_config, arch)
        for i, leaf in enumerate(tree.leaves(build_model(cfg).init(torch.Generator().manual_seed(0)))):
            out[f"params/{arch}/{i}"] = leaf.numpy()
        for k, v in make_inputs(cfg).items():
            out[f"batch/{arch}/{k}"] = v
    path = os.path.join(tmp_dir, "mesh_ssm_inputs.npz")
    np.savez(path, **out)
    return path


# ---------------------------------------------------------------------------
# the reference, in a JAX child
# ---------------------------------------------------------------------------


def reference_main(inputs: str, path: str, ckpt_dir: str):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    import repro.launch.serve as r_serve
    import repro.launch.train as r_train
    from repro.configs import SHAPES as R_SHAPES
    from repro.configs import get, smoke_config
    from repro.configs.base import ShapeSpec
    from repro.launch import profiles as RP
    from repro.models import build_model
    from repro.obs.metrics import MetricsRegistry
    from repro.serve import Engine
    from repro.train import save_checkpoint
    from repro.train import train_loop as TL
    from repro.train.optimizer import OptConfig, init_state

    assert jax.device_count() == 8
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(MESH[0]), MESH[1])
    profiles = {"baseline": RP.BASELINE, "opt": RP.OPT}
    for arch in ARCHS:  # the launchers' checkpoints first: the port's world waits for them
        rp = build_model(smoke_config(arch)).init(jax.random.key(0))
        save_checkpoint(os.path.join(ckpt_dir, "serve", arch), rp, step=1)
        save_checkpoint(os.path.join(ckpt_dir, "train", arch), {"params": rp, "opt": init_state(OptConfig(), rp)},
                        step=TRAIN_CKPT_STEP)
    with open(os.path.join(ckpt_dir, CKPT_READY), "w"):
        pass
    out: dict = {}
    specs: dict = {}
    models = {}
    for arch, shape, prof in SPEC_CASES:
        if arch not in models:  # its param_specs traced once: the leaves' shapes do not depend on the rules
            models[arch] = build_model(get(arch))
            specs_once = models[arch].param_specs()
            models[arch].param_specs = lambda s=specs_once: s
        model = models[arch]
        rules = RP.rules_for(get(arch), R_SHAPES[shape], profiles[prof])
        key = f"{arch}/{shape}/{prof}"
        specs[key + "/params"] = [_spec(s.spec) for s in jax.tree.leaves(TL.param_shardings(model, mesh, rules))]
        specs[key + "/opt"] = [_spec(s.spec) for s in jax.tree.leaves(TL.opt_state_shardings(None, model, mesh, rules))]
        kind = "decode" if R_SHAPES[shape].kind == "decode" else "train"
        specs[key + "/batch"] = {k: _spec(v.spec) for k, v in TL.batch_shardings(model, mesh, rules, kind).items()}
        cache = jax.eval_shape(lambda: model.init_cache(*CACHE))
        specs[key + "/cache"] = [_spec(s.spec) for s in jax.tree.leaves(TL.cache_shardings(model, mesh, rules, cache))]
    out["specs"] = np.array(json.dumps(specs))

    inp = dict(np.load(inputs))
    for arch in ARCHS:
        cfg = small_config(smoke_config, arch)
        m = build_model(cfg)
        treedef = jax.tree.structure(jax.eval_shape(m.init, jax.random.key(0)))
        params = jax.tree.unflatten(treedef, [jnp.asarray(inp[f"params/{arch}/{i}"]) for i in range(treedef.num_leaves)])
        # the forward and one train step on the seeded batch
        b = {k[len(f"batch/{arch}/"):]: jnp.asarray(v) for k, v in inp.items() if k.startswith(f"batch/{arch}/")}
        logits, _, _ = jax.jit(m.forward)(params, b)
        out[f"logits/{arch}"] = np.asarray(logits)
        ocfg = OptConfig(**OPT_CFG)
        rules = RP.rules_for(cfg, ShapeSpec("t", "train", BATCH[1], BATCH[0]), RP.BASELINE)
        newp, _, met = jax.jit(TL.make_train_step(m, ocfg, rules=rules))(params, init_state(ocfg, params), b)
        for i, leaf in enumerate(jax.tree.leaves(newp)):
            out[f"step/{arch}/params/{i}"] = np.asarray(leaf)
        for k in ("loss", "ce", "aux", "grad_norm", "lr"):
            out[f"step/{arch}/{k}"] = np.asarray(met[k])
        # the fixed engine, one process
        eng = Engine(m, params, max_len=MAX_LEN, metrics=MetricsRegistry())
        res = eng.generate(PROMPTS, max_new_tokens=MAX_NEW)
        for i in range(len(PROMPTS)):
            out[f"tokens/{arch}/{i}"] = np.asarray(res.tokens[i][: res.lengths[i]], np.int64)
        # a refeed of seeded tokens through the engine's decode step (the shapes it compiled for):
        # every tick's logits and the state after
        step = eng._step
        B, T, _ = REFEED
        cache = m.init_cache(B, MAX_LEN)
        if m.is_encdec:
            frames = refeed_frames(cfg)
            cache = dict(cache)
            cache["enc_out"] = m._encode_frames(params, jnp.asarray(frames), TL.make_ctx())
            out[f"refeed/{arch}/frames"] = frames
        toks = refeed_tokens(cfg.vocab_size)
        for t in range(T):
            lg, cache = step(params, cache, jnp.asarray(toks[:, t:t + 1]), jnp.full((B,), t, jnp.int32))
            out[f"refeed/{arch}/logits/{t}"] = np.asarray(lg)
        for i, leaf in enumerate(jax.tree.leaves(cache)):
            out[f"refeed/{arch}/cache/{i}"] = np.asarray(leaf)

        # the launchers with --mesh 2x2 on the checkpoints of the bf16 smoke weights
        sys.argv = ["repro.launch.serve", *serve_argv(arch, os.path.join(ckpt_dir, "serve", arch))]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            r_serve.main()
        out[f"launch/{arch}"] = np.array(json.dumps(buf.getvalue().splitlines()))
        if arch in RECURRENT:  # its SyntheticLM feeds tokens alone: no frames, no patches
            run = os.path.join(ckpt_dir, "train_reference", arch)
            shutil.copytree(os.path.join(ckpt_dir, "train", arch), run)
            sys.argv = ["repro.launch.train", "--arch", arch, *TRAIN_ARGV, "--coded-every", "0", "--ckpt", run]
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                r_train.main()
            out[f"train_launch/{arch}"] = np.array(json.dumps(buf.getvalue().splitlines()))
    np.savez(path, **out)


def start_reference(inputs: str, tmp_dir: str):
    """Start :func:`reference_main` in a child with 8 forced host devices;
    :func:`reference_outputs` waits for it."""
    path = os.path.join(tmp_dir, "mesh_ssm_reference.npz")
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(_repo(), "src"), os.path.join(_repo(), "tests")])
    code = f"import torch_mesh_ssm_harness as h; h.reference_main({inputs!r}, {path!r}, {tmp_dir!r})"
    return subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=env), path


def reference_outputs(child, timeout: float = 900) -> str:
    """Wait for the child :func:`start_reference` started; returns the path
    of the ``.npz`` it wrote. The child is killed if it outlives
    ``timeout``."""
    proc, path = child
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, f"reference child failed:\nSTDOUT:\n{stdout}\nSTDERR:\n{stderr}"
    return path


# ---------------------------------------------------------------------------
# the port, on every rank of one world
# ---------------------------------------------------------------------------


def _wait_for(path: str) -> None:
    import time

    t_end = time.monotonic() + CKPT_WAIT_S
    while not os.path.exists(path):
        if time.monotonic() > t_end:
            raise TimeoutError(f"{path} did not appear within {CKPT_WAIT_S} s")
        time.sleep(0.2)


def greedy_ties(model, params, prompts, max_new: int, max_len: int) -> tuple[list, list]:
    """The fixed engine's greedy refeed in one process (``Engine.generate``'s
    loop), and at each generated position of each row the tokens whose
    logit ties the row's maximum: (the rows' tokens, per row a dict
    position → sorted tied tokens)."""
    import torch

    from repro_torch.train.train_loop import make_decode_step

    B, total = len(prompts), max(map(len, prompts)) + max_new
    toks = torch.zeros((B, total), dtype=torch.int32)
    for b, p in enumerate(prompts):
        toks[b, : len(p)] = torch.tensor(p, dtype=torch.int32)
    step, cache = make_decode_step(model), model.init_cache(B, max_len, device="cpu")
    ties: list = [{} for _ in range(B)]
    for t in range(total - 1):
        lg, cache = step(params, cache, toks[:, t:t + 1], torch.full((B,), t, dtype=torch.int32))
        lg = lg[:, 0, : model.cfg.vocab_size]
        for b in range(B):
            if t + 1 >= len(prompts[b]):
                ties[b][t + 1] = torch.nonzero(lg[b] == lg[b].max()).reshape(-1).tolist()
                toks[b, t + 1] = int(torch.argmax(lg[b]))
    return [toks[b, : len(prompts[b]) + max_new].tolist() for b in range(B)], ties


def parse_step_line(line: str) -> tuple[int, float, float]:
    """(step, loss, grad norm) of a launcher's ``step N loss L gnorm G``."""
    f = line.split()
    return int(f[1]), float(f[3]), float(f[5])


def port_main(rank: int, world: int, inputs: str, ckpt_dir: str) -> dict:
    """Every port case on this rank; rank 0 returns the whole results, the
    others what every rank must agree on."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch import tree
    from repro_torch.coded.rs_checkpoint import gather_state
    from repro_torch.configs import smoke_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.profiles import BASELINE, OPT, apply_profile_cfg, rules_for
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.launch.train import main as train_main
    from repro_torch.models import build_model
    from repro_torch.models import layers as L
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.serve import CodedServeGuard, ContinuousEngine, Engine, FaultInjector
    from repro_torch.train import CodedStateGuard, OptConfig, init_state, make_train_step, restore_checkpoint
    from repro_torch.train.train_loop import (batch_shardings, cache_shardings, make_decode_step, opt_state_shardings,
                                              param_shardings, place)

    ref = dict(np.load(inputs))
    res: dict = {}
    mesh = make_mesh(*MESH, device="cpu")
    hosts = make_mesh((world,), ("hosts",), group=dist.new_group(backend="gloo"), device="cpu")
    whole = lambda t: t.full_tensor() if isinstance(t, DTensor) else t  # noqa: E731
    profiles = {"baseline": BASELINE, "opt": OPT}
    serve_rules = lambda cfg, prof: rules_for(cfg, ShapeSpec(*SERVE_SHAPE), profiles[prof])  # noqa: E731
    for key in ("init", "forward", "train", "engine", "refeed", "guard", "continuous", "coded_refused",
                "launch", "train_launch"):
        res[key] = {}

    for arch in ARCHS:
        # Model.init(shardings=) against place(init), whole leaves and in slabs
        bcfg = small_config(smoke_config, arch, "bfloat16")
        bmodel = build_model(bcfg)
        for prof in PROFILES:
            ps = param_shardings(bmodel, mesh, serve_rules(bcfg, prof))
            for slab in (L.SLAB_ELEMENTS, 64 * 32):
                saved, L.SLAB_ELEMENTS = L.SLAB_ELEMENTS, slab
                try:
                    a = bmodel.init(torch.Generator().manual_seed(0), shardings=ps)
                    b = place(bmodel.init(torch.Generator().manual_seed(0)), ps)
                finally:
                    L.SLAB_ELEMENTS = saved
                res["init"][f"{arch}/{prof}/{slab}"] = all(
                    isinstance(x, DTensor) and tuple(x.placements) == tuple(y.placements) and x.shape == y.shape
                    and x.to_local().is_contiguous() and torch.equal(x.to_local(), y.to_local())
                    for x, y in zip(tree.leaves(a), tree.leaves(b), strict=True))

        cfg = small_config(smoke_config, arch)
        model = build_model(cfg)
        params = _leaves_from(ref, f"params/{arch}/", model.param_specs())
        batch = {k[len(f"batch/{arch}/"):]: torch.from_numpy(v) for k, v in ref.items()
                 if k.startswith(f"batch/{arch}/")}
        for prof in PROFILES:
            # the forward and one train step under the training rules (seq over model); under
            # opt the recurrent scans run in checkpointed chunks of 4 steps (the profile's 256
            # would not cut a 16-step batch)
            pcfg = apply_profile_cfg(cfg, profiles[prof])
            if pcfg.ssm is not None and prof == "opt":
                pcfg = pcfg.replace(time_chunk=4)
            pmodel = build_model(pcfg)
            rules = rules_for(pcfg, ShapeSpec("t", "train", BATCH[1], BATCH[0]), profiles[prof])
            ocfg = OptConfig(**OPT_CFG)
            psh, osh, bsh = (param_shardings(pmodel, mesh, rules), opt_state_shardings(ocfg, pmodel, mesh, rules),
                             batch_shardings(pmodel, mesh, rules))
            p0, s0, b0 = place(params, psh), place(init_state(ocfg, params), osh), place(batch, {k: bsh[k] for k in batch})
            logits, _, _ = pmodel.forward(p0, b0, L.Ctx(mesh, rules))
            res["forward"][f"{arch}/{prof}"] = dict(logits=whole(logits), placed=isinstance(logits, DTensor))
            if prof == "baseline":  # a plain batch, every rank's whole (a prefill step's), on the meshed weights
                logits, _, _ = pmodel.forward(p0, batch, L.Ctx(mesh, rules))
                res["forward"][f"{arch}/plain_batch"] = dict(logits=whole(logits), placed=isinstance(logits, DTensor))
            newp, news, met = make_train_step(pmodel, ocfg, rules=rules, mesh=mesh)(p0, s0, b0)
            res["train"][f"{arch}/{prof}"] = dict(
                params=[whole(t) for t in tree.leaves(newp)], metrics={k: float(whole(v)) for k, v in met.items()},
                kept=all(tuple(a.placements) == tuple(b.placements)
                         for a, b in zip(tree.leaves((newp, news["m"], news["v"])), tree.leaves((p0, s0["m"], s0["v"])))))
            # the fixed engine on the mesh
            eng = Engine(model, params, max_len=MAX_LEN, rules=serve_rules(cfg, prof), mesh=mesh,
                         metrics=MetricsRegistry())
            r = eng.generate(PROMPTS, max_new_tokens=MAX_NEW)
            res["engine"][f"{arch}/{prof}"] = [r.tokens[i][: r.lengths[i]].tolist() for i in range(len(PROMPTS))]
            res["engine"][f"{arch}/{prof}/placed"] = all(isinstance(t, DTensor) for t in tree.leaves(eng.params))

        # the refeed through the meshed decode step, and the guard's rank form on its state
        rules = serve_rules(cfg, "baseline")
        B, T, _ = REFEED
        pm = place(params, param_shardings(model, mesh, rules))
        c0 = model.init_cache(B, MAX_LEN, device="cpu")
        cache = place(c0, cache_shardings(model, mesh, rules, c0))
        if model.is_encdec:
            enc = model._encode_frames(params, torch.from_numpy(refeed_frames(cfg)))
            cache["enc_out"].copy_(cache_shardings(model, mesh, rules, c0)["enc_out"].place(enc))
        views = [t.to_local().data_ptr() for t in tree.leaves(cache)]
        step = make_decode_step(model, rules, mesh=mesh)
        toks = torch.from_numpy(refeed_tokens(cfg.vocab_size))
        lgs = []
        for t in range(T):
            lg, out = step(pm, cache, toks[:, t:t + 1], torch.full((B,), t, dtype=torch.int32))
            lgs.append(whole(lg))
        rec = dict(logits=lgs, cache=[whole(t) for t in tree.leaves(cache)],
                   in_place=out is cache and [t.to_local().data_ptr() for t in tree.leaves(cache)] == views,
                   placed=[str(t.placements) for t in tree.leaves(cache)])
        res["refeed"][arch] = rec
        if arch in RECURRENT:
            state = {"tokens": toks, "pos": torch.tensor(T, dtype=torch.int32)}
            guard = CodedServeGuard(K=RANK_K, R=RANK_R, injector=FaultInjector(kills=((T - 1, RANK_KILL),)),
                                    mesh=hosts, axis="hosts")
            held = gather_state((cache, state), keep=rank == 0)
            guard.snapshot(cache, state, tick=T)
            grp = guard.group
            rows = np.stack([grp._mem[j] if grp.hosts is None else grp.hosts.fetch(j) for j in range(guard.N)]) \
                if rank == 0 else None
            dead = guard.poll(T)
            back_cache, back_state = guard.recover(dead)
            back = gather_state((back_cache, back_state), keep=rank == 0)
            g = dict(dead=dead, alive=sorted(guard.alive), host=guard._host)
            if rank == 0:
                g.update(rows=rows, leaves=[t.clone() for t in tree.leaves(held)],
                         bit_exact=all(torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))
                                       for a, b in zip(tree.leaves(back), tree.leaves(held), strict=True)))
            res["guard"][arch] = g

        # no one-pass prefill: the continuous engine refuses the model on a mesh as in one process
        for where, m in (("mesh", mesh), ("one", None)):
            try:
                ContinuousEngine(model, params, mesh=m)
                res["continuous"][f"{arch}/{where}"] = "not refused"
            except NotImplementedError as e:
                res["continuous"][f"{arch}/{where}"] = str(e)
        # --coded needs the continuous engine, on a mesh as in one process
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                serve_main(["--arch", arch, "--smoke", "--mesh", "2x2", "--device", "cpu", "--coded", "2,2"])
            res["coded_refused"][arch] = "not refused"
        except SystemExit as e:
            res["coded_refused"][arch] = str(e)

        # the serving launcher with --mesh 2x2 on the reference's checkpoint (rank 0 prints), and
        # the same greedy refeed in one process with the ties of its bf16 logits
        _wait_for(os.path.join(ckpt_dir, CKPT_READY))
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            serve_main([*serve_argv(arch, os.path.join(ckpt_dir, "serve", arch)), "--device", "cpu"])
        smodel = build_model(smoke_config(arch))
        sp, _ = restore_checkpoint(os.path.join(ckpt_dir, "serve", arch), smodel.param_specs(), device="cpu")
        one, ties = greedy_ties(smodel, sp, [[int(t) for t in p.split(",")] for p in LAUNCH_PROMPTS.split(";")],
                                LAUNCH_NEW, LAUNCH_MAX_LEN)
        res["launch"][arch] = dict(printed=buf.getvalue().splitlines(), one=one, ties=ties)

        # the training launcher with --mesh 2x2 --coded-every 1 resuming from the reference's
        # checkpoint, and the same run in one process
        runs = {}
        for where, extra in (("mesh", []), ("one", ["--mesh", "1x1"])):
            d = os.path.join(ckpt_dir, f"train_{where}_{rank}", arch)
            if where == "one" or rank == 0:
                shutil.copytree(os.path.join(ckpt_dir, "train", arch), d)
            dist.barrier()
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                runs[where] = train_main(["--arch", arch, *TRAIN_ARGV, *extra, "--device", "cpu", "--ckpt",
                                          os.path.join(ckpt_dir, f"train_{where}_0" if where == "mesh"
                                                       else f"train_{where}_{rank}", arch)])
            runs[where]["printed"] = buf.getvalue().splitlines()
        run, one = runs["mesh"], runs["one"]
        g = run["guard"]
        tl = dict(printed=run["printed"], history=run["history"], one_history=one["history"], step=g.step,
                  start=run["start"], held=g._shards is not None,
                  placed=all(isinstance(t, DTensor) for t in tree.leaves(run["state"])))
        gathered = gather_state(run["state"], keep=rank == 0)
        if rank == 0:  # a one-process guard over the gathered state
            og = CodedStateGuard(K=8, device="cpu")
            og.snapshot(gathered, g.step)
            tl["one_guard_equal"] = np.array_equal(og._shards, g._shards) and np.array_equal(og._parity, g._parity)
        res["train_launch"][arch] = tl
    dist.barrier()
    agreed = {"engine": res["engine"], "continuous": res["continuous"],
              "guard": {a: {k: v for k, v in g.items() if k in ("dead", "alive")} for a, g in res["guard"].items()},
              "train_launch": {a: {"history": [{k: h[k] for k in ("step", "loss", "grad_norm")} for h in v["history"]]}
                               for a, v in res["train_launch"].items()}}
    return _numpy(res) if rank == 0 else _numpy(agreed)
