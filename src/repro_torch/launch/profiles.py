"""Sharding/remat optimization profiles: the reference's
``launch/profiles.py``, whose levers were chosen for a TPU mesh.

``baseline`` is the paper-faithful first implementation. Each lever is an
independently-toggleable change with an explicit hypothesis (the reference's
reasoning, kept as it is: the mesh levers act on a mesh of ranks, where
arrays are DTensors placed by the rules; on one device the flags are what
the model reads, e.g. ``moe_gather`` picks the MoE block's gather-form
dispatch):

* ``attn_heads``   — constrain q/k/v to head-sharding inside attention
                     instead of inheriting the block-boundary seq-sharding
                     (kills GSPMD 'involuntary full rematerialization'
                     reshards in the chunked-attention scans).
* ``moe_ep``       — expert parallelism: experts → data axis, expert ff →
                     model axis (weights fully sharded with NO per-layer
                     FSDP all-gather; tokens all-to-all to expert owners).
                     Divisibility: jamba 16e/16, arctic 128e/16, dsv3 256e/16.
* ``moe_gather``   — gather-form MoE dispatch and combine (no scatter-add
                     with computed indices).
* ``logits_vocab`` — constrain lm-head logits to vocab-sharding (batch, ∅,
                     vocab) so the CE never materializes a full-vocab tensor.
* ``no_fsdp``      — drop d_model→data param sharding for models whose
                     sharded-over-model state fits HBM (≤8B params):
                     removes ALL per-layer param gathers; gradient sync
                     becomes one reduce of model-sharded grads.
* ``time_chunk``   — chunked+checkpointed time scans in RWKV/Mamba
                     (256-step chunks): backward saves only chunk-boundary
                     states instead of every step's state.

Besides the sharding levers, :func:`resolve_profile` picks the
coded-checkpoint DP-axis **encode algorithm** from the production mesh's
network topology (``launch.mesh.production_topology`` → ``topo.autotune``):
multi-pod derives a three-level chip < slice < pod hierarchy and selects the
recursive multi-level schedule instead of the flat prepare-and-shoot.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..configs.base import ModelConfig, ShapeSpec
from ..dist.sharding import ShardingRules
from .rules import rules_for as _baseline_rules


@dataclass(frozen=True)
class Profile:
    name: str
    attn_heads: bool = False
    moe_ep: bool = False
    moe_resident: bool = False  # expert weights resident (no expert FSDP)
    moe_gather: bool = False  # gather-form dispatch/combine (no scatter-add)
    dp_only: bool = False  # pure DP for small models: batch over ALL axes
    bf16_moments: bool = False
    logits_vocab: bool = False
    no_fsdp: bool = False
    time_chunk: int = 0


BASELINE = Profile("baseline")
OPT = Profile("opt", attn_heads=True, moe_ep=True, logits_vocab=True,
              no_fsdp=True, time_chunk=256)


def profile_with(name: str, **kw) -> Profile:
    return Profile(name, **kw)


def rules_for(cfg: ModelConfig, shape: ShapeSpec, profile: Profile = BASELINE) -> ShardingRules:
    r = _baseline_rules(cfg, shape)
    flags = set()
    if profile.attn_heads:
        flags.add("attn_heads")
    if profile.logits_vocab:
        flags.add("logits_vocab")
    if profile.moe_gather:
        flags.add("moe_gather")
    if profile.moe_ep:
        r = r.override(experts=("data",), moe_ff=("model",))
    if profile.moe_resident:
        # experts spread over (model, data) when divisible (dsv3: 1/chip),
        # else model only (jamba: 1 per model shard); weights NOT FSDP'd
        r = r.override(experts=("model", "data"), expert_d=())
    if profile.dp_only:
        r = r.override(batch=("pod", "data", "model"), seq=(), d_model=())
    if profile.no_fsdp and _params_fit_without_fsdp(cfg):
        r = r.override(d_model=())
    if flags:
        r = r.with_flags(flags)
    return r


def apply_profile_cfg(cfg: ModelConfig, profile: Profile) -> ModelConfig:
    if profile.time_chunk and cfg.ssm is not None:
        return cfg.replace(time_chunk=profile.time_chunk)
    return cfg


def _params_fit_without_fsdp(cfg: ModelConfig) -> bool:
    """Model-axis-only sharding fits a device when total params ≤ ~8B
    (bf16 params + f32 moments over 16 model shards ≲ 5 GB; the reference's
    threshold, set for a 16 GB TPU v5e chip)."""
    from .roofline import param_counts

    return param_counts(cfg)["total"] <= 8e9


# ---------------------------------------------------------------------------
# coded-checkpoint encode profile: algorithm from the mesh topology
# ---------------------------------------------------------------------------


#: checkpoint generator-matrix kind → the autotuner's generator taxonomy
#: (which structured candidate families are applicable). The production
#: coded-checkpoint parity plan uses a Cauchy matrix (``coded.rs_checkpoint``)
#: — an unstructured MDS generator, hence "general".
_GENERATOR_TAXONOMY = {
    "cauchy": "general",
    "random": "general",
    "general": "general",
    "vandermonde": "vandermonde",
    "dft": "dft",
}

#: the matrix kind ``coded.rs_checkpoint.ParityPlan`` actually builds
CHECKPOINT_GENERATOR_KIND = "cauchy"


def generator_kind_for(matrix_kind: str) -> str:
    """Map a generator-matrix kind (what the caller builds, e.g. the
    checkpoint layer's Cauchy matrix) to the autotuner's generator taxonomy
    ∈ {general, vandermonde, dft} — which structured schedule families may
    be enumerated for it."""
    try:
        return _GENERATOR_TAXONOMY[matrix_kind]
    except KeyError:
        raise ValueError(
            f"unknown generator matrix kind {matrix_kind!r}; "
            f"expected one of {sorted(_GENERATOR_TAXONOMY)}"
        ) from None


@dataclass(frozen=True)
class EncodeProfile:
    """Autotuned encode selection for the coded-checkpoint DP axis.

    ``algorithm`` is the chosen candidate's full name — a plan family
    (prepare-shoot, hierarchical, multilevel, ring, allgather, …) optionally
    suffixed ``+<pipeline>`` when a pass pipeline's rewrite won on price;
    ``pipeline`` is that pipeline's registry name ("" = un-rewritten).
    ``plan`` is the matching compile-time schedule plan (None for the
    plan-less allgather); ``levels`` the innermost-first hierarchy the choice
    was priced on — also the level sizes ``multilevel_encode`` expects its
    ``sizes`` (reversed) to have. The selection is made over priced
    ScheduleIRs (the autotuner enumerates ``plan.to_ir()`` compiles ×
    applicable ``topo.passes`` pipelines); ``ir`` is the chosen candidate's
    compiled, pass-rewritten schedule — the exact object
    ``dist.collectives.ir_encode`` executes (structure-only here: the
    executors recompile with the generator matrix at dispatch and re-apply
    the named pipeline, e.g. ``pipeline="pipeline"`` for the
    comm/compute-overlap rewrite). ``kernels`` is the LocalOp lowering the
    executors should use (one of ``dist.collectives.KERNEL_MODES``; None =
    auto: the hand-written CUDA kernels on the card). ``fitted_costs``
    records the calibrated per-level α/β the pricing used (None = the
    topology model's defaults, the reference's TPU values)."""

    topology: object  # repro_torch.topo Topology the choice was priced on
    algorithm: str
    plan: object
    tune: object  # full repro_torch.topo.TuneResult (candidate table)
    pipeline: str = ""  # winning PassPipeline name ("" = un-rewritten)
    fitted_costs: tuple | None = None  # calibrated LinkCosts used for pricing
    kernels: str | None = None  # ir_encode LocalOp lowering (None = auto)

    @property
    def levels(self) -> tuple[int, ...]:
        return getattr(self.topology, "levels", (self.topology.n,))

    @property
    def ir(self):
        return self.tune.chosen.ir


def resolve_profile(
    *,
    multi_pod: bool = False,
    mesh=None,
    axes=None,
    payload_bytes: int = 1 << 20,
    p: int = 1,
    q: int | None = None,
    measured: dict[str, float] | None = None,
    generator: str | None = None,
    calibration: str | bool | None = None,
    kernels: str | None = None,
) -> EncodeProfile:
    """Pick the coded-checkpoint DP-axis encode algorithm from the mesh
    topology via the autotuner.

    Default: price on :func:`launch.mesh.production_topology` — multi-pod
    derives the three-level chip < slice < pod hierarchy and selects the
    recursive multi-level schedule. Pass ``mesh`` + ``axes`` (outermost →
    innermost, e.g. ``("pod", "slice", "chip")``) to derive the hierarchy
    from a mesh (``launch.mesh.RankMesh``) instead. ``measured`` feeds
    wall-clock calibration (e.g. a calibration record's ``measured_s``)
    through ``autotune(..., measured=...)``.

    ``generator`` is the autotuner taxonomy kind; when omitted it defaults
    from the checkpoint layer's actual generator matrix kind (Cauchy →
    "general") via :func:`generator_kind_for` — callers with structured
    generators pass ``generator=generator_kind_for("vandermonde")`` etc. to
    unlock the structured candidate families.

    ``calibration`` selects fitted α/β pricing: ``None`` (default) loads the
    port's ``results/BENCH_torch_topology.json`` when present
    (``topo.calibrate.DEFAULT_CALIBRATION_PATH``), a path loads that file,
    ``False`` disables calibration. A path ending in ``.jsonl`` or
    ``.trace.json`` is treated as a span trace emitted by
    ``dist.collectives.ir_encode(tracer=...)`` and re-fit on the fly
    via ``obs.feed.fitted_costs_from_trace`` — live telemetry straight
    into pricing, no intermediate results file. When fitted per-level
    costs exist and
    the priced topology is a Hierarchy, its level costs are replaced by the
    fit (level counts matching exactly, otherwise the fitted innermost/
    outermost endpoints re-interpolated through
    ``topo.model.default_level_costs``) so candidate prices — and the chosen
    (algorithm, pipeline) — reflect measured hardware.

    ``kernels`` is recorded verbatim on the profile for dispatch-time use
    (``dist.collectives`` LocalOp lowering mode: None = auto-select by
    device, "cuda"/"fused"/"torch" to force)."""
    from ..core.field import M31
    from ..topo import autotune
    from ..topo.calibrate import load_fitted_costs
    from ..topo.model import Hierarchy, default_level_costs
    from .mesh import production_topology, topology_for_mesh

    if mesh is not None:
        if axes is None:
            raise ValueError("pass axes=(outermost, ..., innermost) with mesh")
        topo = topology_for_mesh(mesh, axes)
    else:
        topo = production_topology(multi_pod=multi_pod)
    fitted = None
    if calibration is not False:
        if isinstance(calibration, str) and calibration.endswith(
            (".jsonl", ".trace.json")
        ):
            from ..obs.feed import fitted_costs_from_trace

            try:
                fitted = tuple(fitted_costs_from_trace(calibration))
            except (OSError, ValueError):  # unreadable/unfittable trace
                fitted = None
        else:
            fitted = load_fitted_costs(
                calibration if isinstance(calibration, str) else None
            )
    if fitted is not None and isinstance(topo, Hierarchy):
        from dataclasses import replace as _replace

        if len(fitted) == len(topo.levels):
            topo = _replace(topo, costs=fitted)
        else:
            topo = _replace(
                topo,
                costs=default_level_costs(
                    len(topo.levels), lo=fitted[0], hi=fitted[-1]
                ),
            )
        fitted = topo.costs
    else:
        fitted = None
    result = autotune(
        topo.n,
        p,
        payload_bytes,
        topo,
        q=q if q is not None else M31,
        generator=generator
        if generator is not None
        else generator_kind_for(CHECKPOINT_GENERATOR_KIND),
        measured=measured,
    )
    return EncodeProfile(
        topology=topo,
        algorithm=result.algorithm,
        plan=result.chosen.plan,
        tune=result,
        pipeline=result.chosen.pipeline,
        fitted_costs=fitted,
        kernels=kernels,
    )
