"""Analytic roofline cost model for complete schedules: the port's copy of
the JAX package's ``core/cost_model.py``, with the hardware a parameter.

Deterministic roofline arithmetic, the search's signal.  The search
compares plans by the estimated step time; infeasible plans (device memory
over capacity) get a large but finite multiplicative penalty so the search
sees a continuous landscape, mirroring Halide schedules that compile but run
slowly.

All byte/FLOP accounting is per *training/serving step* on the whole mesh;
with ``hw`` the ``core.hardware.HardwareSpec`` the cell is priced for:

    compute_s    = FLOPs   / (devices × hw.peak_flops)
    memory_s     = HBM B   / (devices × hw.hbm_bw)
    collective_s = wire B/device / hw.link_bw (hw.pod_link_bw across pods)
    step_s       = max(compute, memory) + (1 - overlap)·collective

The formulas are the JAX package's.  Three of its terms were derived for the
TPU and are not calibrated for the H100 (``launch/measure.py`` times the
card beside them; fitting them is ROADMAP A14): the kernel-tile efficiency
``(bq/(bq+64))·(bkv/(bkv+64))``, the scan's grid-step term and the 5 %
overlap tax.  The spill test is the hardware's
own: under ``tpu-v5e`` the JAX kernel's VMEM working set, under the H100
whether the port's flash kernel launches the tile at all
(``kernels.geometry.flash_launch``).

A batch of plans is encoded once as a structure-of-arrays
(``PlanColumns.from_plans``) and every roofline term is computed as numpy
column math over the whole batch (``_terms_columnar``).  The scalar
``cost()``/``terms()`` route through the same size dispatch as
``cost_batch`` (a batch of one), so the scalar and batched signals cannot
drift apart.  The per-plan arithmetic is kept verbatim as ``_terms_scalar``
— the oracle the kernel is certified against (and the fast path for batches
below ``columnar_min_batch``): the column math performs the same IEEE-754
operations on the same operands in the same order, so the two paths agree
bit for bit.

``pricing="jit"`` is the JAX package's jitted kernel as a float64 torch
program on the model's ``device`` (``_build_jit_kernel``): the same
arithmetic, held to the columnar kernel within ``JIT_RTOL`` and tagged
``JIT_PRICING_TAG``.  torch is imported only when such a model prices a
batch, so the search's import chain (numpy only) stays free of torch.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.core.hardware import H100, TPU_V5E, HardwareSpec
from repro_torch.core.space import MeshSpec, SchedulePlan, ScheduleSpace
from repro_torch.kernels.geometry import flash_launch


HW = H100  # the port's default: the card its kernels run on

BF16 = 2
F32 = 4

# ---------------------------------------------------------------------------
# Discrete plan-field code tables (shared by the columnar kernel and the
# learned-cost featurizer).  Codes index into these tuples; the derived
# boolean lookup tables vectorize the scalar ``in (...)`` membership tests.
# ---------------------------------------------------------------------------
STRATEGIES = ("replicated", "tp", "fsdp", "fsdp_tp", "tp2d")
MOE_MODES = ("ep", "tp", "dense")
REMAT_MODES = ("none", "dots", "full")
GRAD_COMM_MODES = ("fp32", "int8", "rs_ag")

_STRAT_CODE = {s: i for i, s in enumerate(STRATEGIES)}
_MOE_CODE = {m: i for i, m in enumerate(MOE_MODES)}
_REMAT_CODE = {r: i for i, r in enumerate(REMAT_MODES)}
_GRAD_CODE = {g: i for i, g in enumerate(GRAD_COMM_MODES)}

# the ONE definition of which strategies enable each sharding axis —
# the scalar path's membership tests and the kernel's boolean gather
# tables both derive from these (no third copy to drift)
TP_STRATEGIES = frozenset(("tp", "fsdp_tp", "tp2d"))
FSDP_STRATEGIES = frozenset(("fsdp", "fsdp_tp", "tp2d"))
_TP_ON = np.array([s in TP_STRATEGIES for s in STRATEGIES])
_FSDP_ON = np.array([s in FSDP_STRATEGIES for s in STRATEGIES])

# branch constants, in code order — gathered per plan by the kernel with the
# exact values the scalar dict lookups produce
_REMAT_MULT = np.array([3.0, 3.35, 4.0])  # none, dots, full
_GRAD_SCALE_ZERO3 = np.array([2.0, 0.5, 1.0])  # fp32, int8, rs_ag
_GRAD_SCALE_AR = np.array([2.0, 0.25, 1.0])
# resident bytes/param (same expressions as _state_bytes_per_param)
_SBYTES_F32 = BF16 + 2 * 4 + 4
_SBYTES_INT8 = BF16 + 2 * 1.1 + 4

# ---------------------------------------------------------------------------
# The compiled pricing path (``pricing="jit"``).
#
# ``_terms_jitted`` runs the SAME roofline arithmetic as ``_terms_columnar``
# as one float64 torch program over the batch's columns, on the model's
# device.  Every elementwise op is the float64 operation the numpy kernel
# performs, but torch's transcendental functions (log2) need not round as
# numpy's do, so the CONTRACT is relative agreement within ``JIT_RTOL``, not
# bit-equality.  Because the contract is a tolerance, the path carries a
# versioned ``pricing_tag`` distinct from the exact paths: cache snapshots
# and plan-store requests priced under different tags never mix
# (service/store.py keys on the tag).
#
# The JAX package pads each batch to a power of two, which bounds XLA's
# compile cache.  Eager torch compiles nothing per shape, so the port does
# not pad: a batch of n plans is n rows.
# ---------------------------------------------------------------------------
JIT_PRICING_TAG = "analytic-jit-v1"
JIT_RTOL = 1e-9  # |jit - columnar| <= JIT_RTOL * columnar, elementwise
# Unique-batch size at/above which pricing="jit" uses the compiled kernel
# (below it: the exact scalar replay, exactly like columnar_min_batch).
# The JAX package's value; the H100's own crossover is in PERF.md.
JIT_MIN_BATCH = 8


class PlanColumns:
    """Structure-of-arrays encoding of a ``SchedulePlan`` batch.

    One pass over the plan objects extracts every decision field into a
    flat numpy column (discrete string fields as small-int codes, flags as
    booleans, knobs as integers/floats).  This is the ONE encode a pricing
    batch pays: the analytic kernel (``_terms_columnar``) and the learned
    MLP featurizer (``learned_cost.featurize_columns``) both read these
    columns, so a miss batch handed to ``HybridCostBackend`` is encoded
    once whichever backend ends up pricing it.

    ``plans`` keeps the original objects (ordered) so non-columnar
    consumers — the scalar oracle path, test doubles — can fall back
    without re-materializing them.
    """

    __slots__ = (
        "n", "plans", "pod_data", "strategy", "tp_on", "fsdp_on", "tp2d",
        "mixer_tp", "seq_shard", "ffn_tp", "moe_mode", "moe_ep", "moe_tp",
        "vocab_shard", "remat", "microbatches", "bq", "bkv", "scan_chunk",
        "grad_comm", "overlap", "opt_int8", "kv_int8",
    )

    @classmethod
    def from_plans(cls, plans: Sequence[SchedulePlan]) -> "PlanColumns":
        self = cls.__new__(cls)
        self.n = len(plans)
        self.plans = list(plans)
        self.pod_data = np.array(
            [p.batch_axes == "pod_data" for p in plans], dtype=bool
        )
        strat = np.array([_STRAT_CODE[p.param_strategy] for p in plans],
                         dtype=np.int64)
        self.strategy = strat
        self.tp_on = _TP_ON[strat]
        self.fsdp_on = _FSDP_ON[strat]
        self.tp2d = strat == _STRAT_CODE["tp2d"]
        self.mixer_tp = np.array([p.mixer_tp for p in plans], dtype=bool)
        self.seq_shard = np.array([p.seq_shard for p in plans], dtype=bool)
        self.ffn_tp = np.array([p.ffn_tp for p in plans], dtype=bool)
        moe = np.array([_MOE_CODE[p.moe_mode] for p in plans], dtype=np.int64)
        self.moe_mode = moe
        self.moe_ep = moe == _MOE_CODE["ep"]
        self.moe_tp = moe == _MOE_CODE["tp"]
        self.vocab_shard = np.array([p.vocab_shard for p in plans], dtype=bool)
        self.remat = np.array([_REMAT_CODE[p.remat] for p in plans],
                              dtype=np.int64)
        self.microbatches = np.array([p.microbatches for p in plans],
                                     dtype=np.int64)
        self.bq = np.array([p.attn_block[0] for p in plans], dtype=np.int64)
        self.bkv = np.array([p.attn_block[1] for p in plans], dtype=np.int64)
        self.scan_chunk = np.array([p.scan_chunk for p in plans],
                                   dtype=np.int64)
        self.grad_comm = np.array([_GRAD_CODE[p.grad_comm] for p in plans],
                                  dtype=np.int64)
        self.overlap = np.array([p.overlap for p in plans], dtype=np.float64)
        self.opt_int8 = np.array([p.opt_dtype == "int8" for p in plans],
                                 dtype=bool)
        self.kv_int8 = np.array([p.kv_dtype == "int8" for p in plans],
                                dtype=bool)
        return self

    def stage_onehots(self, stage) -> List[np.ndarray]:
        """Boolean indicator columns, one per option of ``stage``, in
        option order — ``stage_onehots(s)[a][i]`` is True iff plan ``i``
        chose option ``a``.  The vectorized equivalent of the learned
        featurizer's per-stage one-hot block (``learned_cost.featurize``),
        shared so both cost backends read one encoding."""
        name = stage.name
        if name == "attn_block":
            return [(self.bq == q) & (self.bkv == k) for q, k in stage.options]
        if name == "batch_axes":
            return [self.pod_data == (o == "pod_data") for o in stage.options]
        coded = {
            "param_strategy": (self.strategy, _STRAT_CODE),
            "moe_mode": (self.moe_mode, _MOE_CODE),
            "remat": (self.remat, _REMAT_CODE),
            "grad_comm": (self.grad_comm, _GRAD_CODE),
        }
        if name in coded:
            col, code = coded[name]
            return [col == code[o] for o in stage.options]
        if name in ("opt_dtype", "kv_dtype"):
            col = self.opt_int8 if name == "opt_dtype" else self.kv_int8
            return [col == (o == "int8") for o in stage.options]
        col = getattr(self, name)  # bool flags / numeric knobs
        return [col == o for o in stage.options]


@dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    step_s: float
    flops: float  # whole-step HLO-equivalent FLOPs (all chips)
    hbm_bytes: float  # whole-step HBM traffic (all chips)
    coll_bytes_per_chip: float
    hbm_per_chip: float  # resident bytes per chip
    feasible: bool
    model_flops: float  # 6·N_active·D
    details: Dict[str, float] = field(default_factory=dict)

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def mfu(self) -> float:
        """MODEL_FLOPS / (step_s × chips × peak) — filled by caller context."""
        return self.details.get("mfu", 0.0)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["dominant"] = self.dominant
        return d


class _EvalContext:
    """Plan-independent evaluation state for ``terms``.

    Everything here is a pure function of (cfg, shape, mesh, hw) — or of one
    of the handful of *discrete* plan fields (the TP degree, the KV dtype,
    the flash block pair) — so it can be computed once and reused across a
    whole batch of plans.  Only WHOLE subexpressions are memoized, exactly
    as the scalar path computes them (the per-layer accumulation loops run
    unchanged, once per distinct key); sums are never re-associated, so a
    cached context and a fresh one produce bit-identical IEEE-754 results.

    ``terms`` builds a fresh context per call (scalar evaluation does the
    same work it always did); ``cost_batch`` keeps one context alive on the
    model instance and amortizes the accounting across the batch — this
    asymmetry is what makes batched leaf evaluation cheaper than N scalar
    calls while ``cost_batch(plans) == [cost(p) for p in plans]`` stays an
    exact (``==``) contract, enforced by the hypothesis property tests.
    """

    __slots__ = (
        "m", "_fwd_total", "_param_bytes", "_param_count", "_groups",
        "_layer_counts", "_act_mults", "_kv_totals", "_vmem_spill",
        "_n_periods", "_n_active",
    )

    def __init__(self, model: "AnalyticCostModel"):
        self.m = model
        self._fwd_total: Optional[float] = None
        self._param_bytes: Optional[float] = None
        self._param_count: Optional[int] = None
        self._groups: Optional[Dict[str, int]] = None
        self._layer_counts: Optional[Tuple[int, int, int, int]] = None
        self._act_mults: Dict[int, Tuple[float, float]] = {}
        self._kv_totals: Dict[float, float] = {}
        self._vmem_spill: Dict[Tuple[int, int], bool] = {}
        self._n_periods: Optional[int] = None
        self._n_active: Optional[int] = None

    def n_periods(self) -> int:
        if self._n_periods is None:
            self._n_periods = self.m.cfg.n_periods
        return self._n_periods

    def active_param_count(self) -> int:
        if self._n_active is None:
            self._n_active = self.m.cfg.active_param_count()
        return self._n_active

    def fwd_flops(self) -> float:
        if self._fwd_total is None:
            self._fwd_total = self.m._fwd_flops()[0]
        return self._fwd_total

    def param_count(self) -> int:
        if self._param_count is None:
            self._param_count = self.m.cfg.param_count()
        return self._param_count

    def param_bytes(self) -> float:
        if self._param_bytes is None:
            self._param_bytes = self.m._param_bytes()
        return self._param_bytes

    def param_groups(self) -> Dict[str, int]:
        if self._groups is None:
            self._groups = self.m._param_groups()
        return self._groups

    def layer_counts(self) -> Tuple[int, int, int, int]:
        """(attn, mamba, dense, moe) layer counts per period — integers, so
        replacing the per-plan counting loop is exact."""
        if self._layer_counts is None:
            na = nm = nd = ne = 0
            for spec in self.m.cfg.layer_plan():
                if spec.mixer == "attn":
                    na += 1
                else:
                    nm += 1
                if spec.mlp == "dense":
                    nd += 1
                elif spec.mlp == "moe":
                    ne += 1
            self._layer_counts = (na, nm, nd, ne)
        return self._layer_counts

    def act_mults(self, tp: int) -> Tuple[float, float]:
        """(ffn_mult, mixer_mult) stored-activation multipliers; the loop
        divides by ``tp`` per term, so it is keyed by the (two-valued) TP
        degree and re-run verbatim per key."""
        got = self._act_mults.get(tp)
        if got is None:
            cfg = self.m.cfg
            ffn_mult = 0.0
            mixer_mult = 0.0
            for spec in cfg.layer_plan():
                if spec.mlp == "dense":
                    ffn_mult += 2 * cfg.d_ff / tp
                elif spec.mlp == "moe":
                    ffn_mult += 2 * cfg.experts_per_token * 1.25 * cfg.d_ff / tp
                if spec.mixer == "attn":
                    mixer_mult += (
                        cfg.n_heads + 2 * cfg.n_kv_heads
                    ) * cfg.resolved_head_dim / tp
                else:
                    mixer_mult += 3 * cfg.d_inner / tp
            got = self._act_mults[tp] = (ffn_mult, mixer_mult)
        return got

    def kv_total(self, kv_bytes: float) -> float:
        """Whole-model KV/scan-state bytes before sharding, keyed by the
        (two-valued) per-element KV byte width."""
        got = self._kv_totals.get(kv_bytes)
        if got is None:
            cfg, shape = self.m.cfg, self.m.shape
            total = 0.0
            for spec in cfg.layer_plan():
                if spec.mixer == "attn":
                    total += (
                        2 * shape.global_batch * cfg.n_kv_heads
                        * shape.seq_len * cfg.resolved_head_dim * kv_bytes
                    )
                else:
                    total += shape.global_batch * cfg.d_inner * (
                        cfg.ssm_state * F32 + (cfg.conv_width - 1) * BF16
                    )
            got = self._kv_totals[kv_bytes] = total
        return got

    def vmem_spills(self, bq: int, bkv: int) -> bool:
        """Whether the flash tile misses the hardware's kernel budget: under
        ``tpu-v5e`` the JAX kernel's double-buffered VMEM working set over
        three quarters of VMEM; under the H100 the port's kernel refusing
        the tile (``geometry.flash_launch`` raises)."""
        key = (bq, bkv)
        got = self._vmem_spill.get(key)
        if got is None:
            m = self.m
            if m.hw.name == TPU_V5E.name:
                got = (
                    2 * _tpu_flash_vmem_bytes(bq, bkv, m.cfg.resolved_head_dim)
                    > m.hw.vmem_bytes * 0.75
                )
            elif m.hw.name == H100.name:
                seq = m.shape.seq_len
                try:
                    flash_launch(1, 1, seq, seq, m.cfg.resolved_head_dim, m.cfg.dtype, bq, bkv)
                    got = False
                except ValueError:
                    got = True
            else:
                raise ValueError(f"no spill test for hardware {m.hw.name!r}")
            self._vmem_spill[key] = got
        return got


def _tpu_flash_vmem_bytes(
    block_q: int, block_kv: int, head_dim: int, dtype_bytes: int = 2
) -> int:
    """Working-set estimate for one grid step of the JAX package's Pallas
    flash kernel (a copy of its ``kernels/geometry.flash_vmem_bytes``)."""
    io = (block_q + 2 * block_kv + block_q) * head_dim * dtype_bytes
    scratch = (block_q * (2 + head_dim)) * 4
    return io + scratch


class AnalyticCostModel:
    def __init__(
        self,
        cfg: ModelConfig,
        shape: InputShape,
        mesh: MeshSpec,
        hw: HardwareSpec = HW,
        columnar: bool = True,
        columnar_min_batch: Optional[int] = None,
        pricing: Optional[str] = None,
        device=None,
    ):
        self.cfg = cfg
        self.shape = shape
        self.mesh = mesh
        self.hw = hw
        # pricing selects the batch kernel behind the one dispatch:
        #   "scalar"   — the pre-columnar protocol end to end (fresh-context
        #                scalar terms(), per-unique-plan replay in
        #                cost_batch): the oracle the kernels are certified
        #                against;
        #   "columnar" — (default) the vectorized numpy kernel
        #                (_terms_columnar), bit-identical to scalar;
        #   "jit"      — the float64 torch program (_terms_jitted) on
        #                ``device`` (default "cuda"): same arithmetic,
        #                agreement within JIT_RTOL (a distinct versioned
        #                pricing_tag, so cached values never mix with the
        #                exact paths).
        # The legacy columnar=False spelling maps to pricing="scalar".
        if pricing is None:
            pricing = "columnar" if columnar else "scalar"
        if pricing not in ("scalar", "columnar", "jit"):
            raise ValueError(f"unknown pricing path: {pricing!r}")
        # the jit kernel's device, checked here so that a model asked for the
        # card raises at once on a machine without one; the exact paths
        # never touch torch
        self.device = None
        if pricing == "jit":
            from repro_torch.device import resolve_device

            self.device = str(resolve_device("cuda" if device is None else device))
        self.pricing = pricing
        self.columnar = pricing != "scalar"
        # Unique-plan count below which a columnar batch dispatches to the
        # scalar replay instead of the kernel: numpy column dispatch costs
        # ~2us/op regardless of width (plus ~25 fresh temp buffers per
        # call), so small batches — greedy rollout sweeps, single leaves,
        # half-warm lockstep rounds — price faster as scalar walks.  The
        # columnar/scalar paths are certified bit-identical, so the
        # threshold is a pure performance knob — results cannot depend on
        # it.  Under pricing="jit" the knob defaults to JIT_MIN_BATCH and
        # batches below it use the EXACT scalar replay, so there the
        # threshold selects between tagged pricing paths.  Set to 1 to force
        # every batch through the kernel (the differential tests do).
        if columnar_min_batch is None:
            columnar_min_batch = JIT_MIN_BATCH if pricing == "jit" else 16
        self.columnar_min_batch = columnar_min_batch
        self.n_evals = 0
        self._batch_ctx: Optional[_EvalContext] = None
        self._jit_fn = None  # built (and torch imported) on first jit pricing
        self.n_jit_batches = 0  # batches the compiled kernel priced

    @property
    def pricing_tag(self) -> str:
        """Version tag of the value-producing pricing path: "exact" for the
        bit-identical scalar/columnar pair, JIT_PRICING_TAG for the
        tolerance-contract jitted kernel.  Store/cache keys include the
        tag whenever it is not "exact" so values from different contracts
        never mix (see service/store.py)."""
        return JIT_PRICING_TAG if self.pricing == "jit" else "exact"

    def __getstate__(self):
        # the batch context holds derived caches only — drop it so pickled
        # models (process-pool workers) stay lean; it lazily rebuilds.
        # The compiled kernel's closure rebuilds the same way.
        d = self.__dict__.copy()
        d["_batch_ctx"] = None
        d["_jit_fn"] = None
        return d

    # ------------------------------------------------------------------
    def _sizes(self, plan: SchedulePlan):
        mesh = self.mesh
        dp = mesh.axis("data")
        if plan.batch_axes == "pod_data" and mesh.multi_pod:
            dp *= mesh.axis("pod")
        tp_on = plan.param_strategy in TP_STRATEGIES
        tp = mesh.axis("model") if tp_on else 1
        fsdp = dp if plan.param_strategy in FSDP_STRATEGIES else 1
        return dp, tp, fsdp, tp_on

    # ------------------------------------------------------------------
    # Structural FLOP / byte accounting
    # ------------------------------------------------------------------
    def _layer_flops_fwd(self, tokens: int, kv_len: int) -> Dict[str, float]:
        """Forward FLOPs per *period*, for `tokens` processed tokens."""
        cfg = self.cfg
        out: Dict[str, float] = {"attn_proj": 0, "attn_sdpa": 0, "mamba": 0, "mlp": 0, "moe": 0}
        hd = cfg.resolved_head_dim
        for spec in cfg.layer_plan():
            d = cfg.d_model
            if spec.mixer == "attn":
                qo = 2 * tokens * d * cfg.n_heads * hd * 2
                kv = 2 * tokens * d * cfg.n_kv_heads * hd * 2
                out["attn_proj"] += qo + kv
                if self.shape.kind == "decode":
                    sdpa = 2 * 2 * tokens * cfg.n_heads * hd * kv_len
                else:
                    sdpa = 2 * 2 * tokens * cfg.n_heads * hd * (kv_len / 2)
                out["attn_sdpa"] += sdpa
            else:
                Di, N = cfg.d_inner, cfg.ssm_state
                dtr = cfg.resolved_dt_rank
                m = 2 * tokens * d * 2 * Di  # in_proj
                m += 2 * tokens * cfg.conv_width * Di
                m += 2 * tokens * Di * (dtr + 2 * N)
                m += 2 * tokens * dtr * Di
                m += 8 * tokens * Di * N  # scan: exp, mul-add state, reduce
                m += 2 * tokens * Di * d  # out_proj
                out["mamba"] += m
            if spec.mlp == "dense":
                mats = 3 if cfg.act == "swiglu" else 2
                out["mlp"] += 2 * tokens * d * cfg.d_ff * mats
            elif spec.mlp == "moe":
                mats = 3 if cfg.act == "swiglu" else 2
                routed = tokens * cfg.experts_per_token * 1.25  # capacity factor
                out["moe"] += 2 * routed * d * cfg.d_ff * mats
                out["moe"] += 2 * tokens * d * cfg.n_experts  # router
        return out

    def _fwd_flops(self) -> Tuple[float, Dict[str, float]]:
        cfg, shape = self.cfg, self.shape
        tokens = shape.tokens  # decode: batch; train/prefill: B*S
        kv_len = shape.seq_len
        per_period = self._layer_flops_fwd(tokens, kv_len)
        total = sum(per_period.values()) * cfg.n_periods
        head = 2 * tokens * cfg.d_model * cfg.vocab_size
        total += head
        per_period["head"] = head
        return total, per_period

    # ------------------------------------------------------------------
    def _param_bytes(self) -> float:
        return self.cfg.param_count() * BF16

    def _param_groups(self) -> Dict[str, int]:
        """Parameter counts by shardability family."""
        cfg = self.cfg
        groups = {"mixer": 0, "ffn": 0, "moe": 0, "vocab": 0, "other": 0}
        for spec in cfg.layer_plan():
            groups["mixer"] += cfg._mixer_params(spec)
            total, _ = cfg._mlp_params(spec)
            if spec.mlp == "moe":
                groups["moe"] += total
            else:
                groups["ffn"] += total
            groups["other"] += 2 * cfg.d_model
        for k in ("mixer", "ffn", "moe", "other"):
            groups[k] *= cfg.n_periods
        emb = cfg.vocab_size * cfg.d_model
        groups["vocab"] = emb if cfg.tie_embeddings else 2 * emb
        return groups

    def _sharded_param_bytes(
        self, plan: SchedulePlan, tp: int, ctx: Optional[_EvalContext] = None
    ) -> float:
        """Per-model-axis-sharded parameter bytes (before the FSDP split):
        the quantity ZeRO-3 must all-gather and the TP axis must hold."""
        cfg = self.cfg
        g = ctx.param_groups() if ctx is not None else self._param_groups()
        tot = 0.0
        tot += g["mixer"] / (tp if plan.mixer_tp and tp > 1 else 1)
        tot += g["ffn"] / (tp if plan.ffn_tp and tp > 1 else 1)
        if g["moe"]:
            if plan.moe_mode == "ep" and tp > 1:
                tot += g["moe"] / min(tp, cfg.n_experts)
            elif plan.moe_mode == "tp" and tp > 1:
                tot += g["moe"] / tp
            else:
                tot += g["moe"]
        vshard = (
            tp if plan.vocab_shard and tp > 1 and cfg.vocab_size % tp == 0 else 1
        )
        tot += g["vocab"] / vshard
        tot += g["other"]
        return tot * BF16

    def _state_bytes_per_param(self, plan: SchedulePlan) -> float:
        """Resident bytes/param incl. the bf16 param itself, the Adam
        moments, and the f32 grad accumulator (matches training/optimizer.py:
        params are single-copy bf16, moments fp32 or rowwise-int8+scale)."""
        if plan.opt_dtype == "int8":
            return BF16 + 2 * 1.1 + 4
        return BF16 + 2 * 4 + 4

    def _activation_bytes_resident(
        self, plan: SchedulePlan, dp: int, tp: int,
        ctx: Optional[_EvalContext] = None,
    ) -> float:
        """Stored activations per chip between fwd and bwd (train only)."""
        cfg, shape = self.cfg, self.shape
        if shape.kind != "train":
            return 0.0
        tokens_local = shape.tokens / dp / max(plan.microbatches, 1)
        d = cfg.d_model
        # bytes stored per token per layer, by remat policy
        if ctx is None:
            ctx = _EvalContext(self)
        ffn_mult, mixer_mult = ctx.act_mults(tp)
        n_per = cfg.n_periods
        if plan.remat == "full":
            stored = tokens_local * d * n_per  # period-boundary inputs only
        elif plan.remat == "dots":
            stored = tokens_local * (d * 4 + mixer_mult * 0.5 + ffn_mult * 0.5) * n_per
        else:
            stored = tokens_local * (d * 6 + mixer_mult + ffn_mult) * n_per
        logits = 0.0
        if plan.remat == "none":
            logits = tokens_local * cfg.vocab_size / (tp if plan.vocab_shard else 1)
        return stored * BF16 + logits * BF16

    def _kv_cache_bytes_per_chip(
        self, plan: SchedulePlan, dp: int, tp: int,
        ctx: Optional[_EvalContext] = None,
    ) -> float:
        cfg, shape = self.cfg, self.shape
        if shape.kind != "decode":
            return 0.0
        kv_bytes = 1.06 if plan.kv_dtype == "int8" else BF16  # int8 + scales
        if ctx is None:
            ctx = _EvalContext(self)
        total = ctx.kv_total(kv_bytes)
        total *= cfg.n_periods
        dp_used = min(dp, max(shape.global_batch, 1))
        shard = dp_used
        if plan.seq_shard:
            # the sequence dim absorbs whatever the batch dim can't use
            shard *= (dp // dp_used) * (tp if not plan.mixer_tp else 1)
        if plan.mixer_tp and plan.param_strategy in TP_STRATEGIES:
            shard *= min(tp, max(cfg.n_kv_heads, 1))
        return total / shard

    # ------------------------------------------------------------------
    # Collectives
    # ------------------------------------------------------------------
    def _collective_bytes_per_chip(
        self, plan: SchedulePlan, dp: int, tp: int, fsdp: int,
        ctx: Optional[_EvalContext] = None,
    ) -> Tuple[float, Dict[str, float]]:
        cfg, shape = self.cfg, self.shape
        if ctx is None:
            ctx = _EvalContext(self)
        train = shape.kind == "train"
        out: Dict[str, float] = {}
        total = 0.0
        n_mb = max(plan.microbatches, 1)
        tokens_local = shape.tokens / min(dp, max(shape.global_batch, 1))

        # --- parameter-axis collectives ---
        p_tp_bytes = self._sharded_param_bytes(plan, tp, ctx)
        if train:
            if fsdp > 1:
                # ZeRO-3: AG params in fwd + AG in bwd + RS grads, per microbatch
                shard_bytes = p_tp_bytes / fsdp
                ag = shard_bytes * (fsdp - 1)
                grad_scale = {"fp32": 2.0, "rs_ag": 1.0, "int8": 0.5}[plan.grad_comm]
                rs = shard_bytes * (fsdp - 1) * grad_scale
                out["zero3"] = (2 * ag + rs) * n_mb
            else:
                # pure DP gradient all-reduce over dp
                wire = 2 * p_tp_bytes * (dp - 1) / dp
                wire *= {"fp32": 2.0, "rs_ag": 1.0, "int8": 0.25}[plan.grad_comm]
                out["grad_allreduce"] = wire
        elif plan.param_strategy == "tp2d" and fsdp > 1:
            # inference weight gather-on-use over the data axis
            out["weight_gather"] = p_tp_bytes / fsdp * (fsdp - 1)
        # --- TP activation collectives (per layer pair of matmuls) ---
        if tp > 1:
            act = tokens_local * cfg.d_model * BF16
            n_attn, n_mamba, n_dense, n_moe = ctx.layer_counts()
            n_ar = 0
            if plan.mixer_tp:
                n_ar += n_attn + n_mamba
            if plan.ffn_tp:
                n_ar += n_dense
            if plan.moe_mode == "tp":
                n_ar += n_moe
            n_ar *= cfg.n_periods
            wire_one = 2 * act * (tp - 1) / tp  # ring AR
            if plan.seq_shard:
                wire_one *= 0.5  # RS+AG replaces AR: half the wire bytes
            coll = n_ar * wire_one
            if train:
                coll *= 3  # fwd + both bwd directions
            out["tp_act"] = coll
            if plan.vocab_shard:
                lg = tokens_local * cfg.d_model * BF16
                out["vocab"] = 2 * lg * (tp - 1) / tp * (3 if train else 1)
        # --- MoE all-to-all ---
        if cfg.is_moe and plan.moe_mode == "ep" and tp > 1:
            ep = min(tp, cfg.n_experts)
            a2a = tokens_local * cfg.experts_per_token * 1.25 * cfg.d_model * BF16
            wire = 2 * a2a * (ep - 1) / ep  # dispatch + combine
            out["moe_a2a"] = wire * (3 if train else 1)
        total = sum(out.values())
        return total, out

    # ------------------------------------------------------------------
    def _ctx(self) -> _EvalContext:
        ctx = self._batch_ctx
        if ctx is None:
            ctx = self._batch_ctx = _EvalContext(self)
        return ctx

    def terms(
        self, plan: SchedulePlan, _ctx: Optional[_EvalContext] = None
    ) -> RooflineTerms:
        """Roofline terms for one plan.

        Columnar mode (the default) prices through the same kernel
        dispatch as ``cost_batch`` — a batch of one lands below
        ``columnar_min_batch``, so it runs the certified scalar replay
        over the shared persistent context (force ``columnar_min_batch=1``
        to exercise the column kernel itself).  ``columnar=False`` (or an
        explicit ``_ctx``, the pre-columnar batch protocol) replays the
        per-plan scalar arithmetic with a fresh context, exactly as before
        the refactor; values are bit-identical every way.
        """
        self.n_evals += 1
        if _ctx is not None or not self.columnar:
            return self._terms_scalar(plan, _ctx)
        if self.columnar_min_batch <= 1:
            cols = PlanColumns.from_plans([plan])
            return self._assemble_terms(
                self._terms_columnar(cols, self._ctx()), 0
            )
        return self._terms_scalar(plan, self._ctx())

    def _terms_scalar(
        self, plan: SchedulePlan, _ctx: Optional[_EvalContext] = None
    ) -> RooflineTerms:
        """The pre-columnar per-plan arithmetic — kept verbatim as the
        oracle ``_terms_columnar`` is certified against.  Scalar calls
        build a fresh ``_EvalContext``; the (pre-columnar) batch path
        passes its persistent context so plan-independent accounting
        amortizes — bit-identical either way (see ``_EvalContext``)."""
        ctx = _ctx if _ctx is not None else _EvalContext(self)
        cfg, shape, hw = self.cfg, self.shape, self.hw
        chips = self.mesh.size
        dp, tp, fsdp, tp_on = self._sizes(plan)
        train = shape.kind == "train"
        n_mb = max(plan.microbatches, 1)

        # ---- compute ----
        fwd = ctx.fwd_flops()
        if train:
            remat_mult = {"none": 3.0, "dots": 3.35, "full": 4.0}[plan.remat]
            flops = fwd * remat_mult + 10.0 * ctx.param_count()
        else:
            flops = fwd
        # kernel-tile efficiency: MXU alignment + grid overhead
        bq, bkv = plan.attn_block
        eff = (bq / (bq + 64.0)) * (bkv / (bkv + 64.0)) / (512.0 / 576.0) ** 2
        eff = min(eff, 1.0)
        if cfg.n_heads:
            if ctx.vmem_spills(bq, bkv):
                eff *= 0.5
        mb_eff = 1.0 - 0.015 * math.log2(n_mb) if n_mb > 1 else 1.0
        overlap_tax = 1.05 if plan.overlap >= 0.9 else 1.0
        compute_s = flops / (chips * hw.peak_flops) / (eff * mb_eff) * overlap_tax
        if cfg.is_ssm:
            # sequential scan: chunk too small -> grid overhead, too large -> VMEM
            chunk = plan.scan_chunk
            grid_steps = (shape.tokens / max(dp, 1)) / chunk * (cfg.d_inner / 256.0)
            compute_s += grid_steps * 0.3e-6 / max(chips / dp, 1)

        # ---- memory (HBM traffic, accounted per chip) ----
        p_tp_mem = self._sharded_param_bytes(plan, tp, ctx)
        # each chip streams its (TP-sharded, ZeRO-gathered) weights per
        # microbatch pass; fwd + bwd for training
        weight_reads = p_tp_mem * n_mb * (2 if train else 1)
        opt_traffic = 0.0
        if train:
            sbytes = self._state_bytes_per_param(plan)
            params_per_chip = p_tp_mem / BF16 / fsdp
            opt_traffic = params_per_chip * (2 * sbytes + 4)  # rw states + grad
        act_traffic = (
            shape.tokens / min(dp, max(shape.global_batch, 1))
            * cfg.d_model * BF16 * cfg.n_layers
            * (6 if train else 3)
        )
        if train and plan.remat != "none":
            act_traffic *= 1.35  # recompute re-streams activations
        kv_traffic = self._kv_cache_bytes_per_chip(plan, dp, tp, ctx)
        per_chip_traffic = weight_reads + opt_traffic + act_traffic + kv_traffic
        hbm_bytes = per_chip_traffic * chips
        memory_s = per_chip_traffic / hw.hbm_bw

        # ---- collectives ----
        coll_per_chip, coll_parts = self._collective_bytes_per_chip(
            plan, dp, tp, fsdp, ctx
        )
        link = hw.link_bw
        if self.mesh.multi_pod and plan.batch_axes == "pod_data":
            # DP collectives cross the pod boundary at lower bandwidth
            pod_frac = coll_parts.get("grad_allreduce", 0) + coll_parts.get("zero3", 0)
            link_eff = (
                (coll_per_chip - pod_frac) / max(coll_per_chip, 1e-9) * hw.link_bw
                + pod_frac / max(coll_per_chip, 1e-9) * hw.pod_link_bw
            )
            link = max(link_eff, hw.pod_link_bw)
        collective_s = coll_per_chip / link

        # ---- capacity ----
        p_tp = self._sharded_param_bytes(plan, tp, ctx)
        params_per_chip = p_tp / BF16 / fsdp
        resident = params_per_chip * (
            self._state_bytes_per_param(plan) if train else BF16
        )
        per_chip = (
            resident
            + self._activation_bytes_resident(plan, dp, tp, ctx)
            + self._kv_cache_bytes_per_chip(plan, dp, tp, ctx)
        )
        feasible = per_chip <= hw.hbm_bytes * 0.92  # fragmentation headroom

        step_s = max(compute_s, memory_s) + (1.0 - plan.overlap) * collective_s
        if not feasible:
            step_s *= 100.0 * (1.0 + per_chip / hw.hbm_bytes)

        n_active = cfg.active_param_count()
        model_flops = 6.0 * n_active * shape.tokens if train else 2.0 * n_active * shape.tokens
        details = dict(coll_parts)
        details["eff"] = eff
        details["mfu"] = model_flops / (step_s * chips * hw.peak_flops)
        return RooflineTerms(
            compute_s=compute_s,
            memory_s=memory_s,
            collective_s=collective_s,
            step_s=step_s,
            flops=flops,
            hbm_bytes=hbm_bytes,
            coll_bytes_per_chip=coll_per_chip,
            hbm_per_chip=per_chip,
            feasible=feasible,
            model_flops=model_flops,
            details=details,
        )

    # ------------------------------------------------------------------
    # The columnar kernel
    # ------------------------------------------------------------------
    def _terms_columnar(self, cols: PlanColumns, ctx: _EvalContext) -> dict:
        """Every roofline term for a whole encoded batch, as numpy column
        math — the single pricing kernel behind ``cost``, ``cost_batch``
        and ``cost_columns``.

        Bit-identity with ``_terms_scalar`` is engineered, not hoped for:
        every column expression performs the scalar path's IEEE-754
        operations on the same operands in the same association order
        (elementwise float64 ops are correctly rounded, so ``a op b`` is
        the same double either way); branch-dependent constants are
        gathered per discrete key with the values the scalar dict lookups
        produce; and parts a plan's branches skip contribute exact ``0.0``
        addends (``x + 0.0 == x`` for the non-negative quantities summed
        here).  The differential grid and the hypothesis properties
        assert the resulting equality on every value."""
        cfg, shape, hw, mesh = self.cfg, self.shape, self.hw, self.mesh
        n = cols.n
        train = shape.kind == "train"
        decode = shape.kind == "decode"
        chips = mesh.size
        gbm = max(shape.global_batch, 1)

        # ---- mesh sizes (ints, exact in float64) ----
        dp = np.full(n, mesh.axis("data"), dtype=np.int64)
        if mesh.multi_pod:
            dp = np.where(cols.pod_data, dp * mesh.axis("pod"), dp)
        tp = np.where(cols.tp_on, mesh.axis("model"), 1)
        fsdp = np.where(cols.fsdp_on, dp, 1)
        n_mb = np.maximum(cols.microbatches, 1)
        dp_eff = np.minimum(dp, gbm)

        # ---- compute ----
        fwd = ctx.fwd_flops()
        if train:
            flops = fwd * _REMAT_MULT[cols.remat] + 10.0 * ctx.param_count()
        else:
            flops = np.full(n, float(fwd))
        k_tile = (512.0 / 576.0) ** 2
        eff = (cols.bq / (cols.bq + 64.0)) * (cols.bkv / (cols.bkv + 64.0)) / k_tile
        eff = np.minimum(eff, 1.0)
        if cfg.n_heads:
            pairs = set(zip(cols.bq.tolist(), cols.bkv.tolist()))
            if len(pairs) == 1:
                if ctx.vmem_spills(*next(iter(pairs))):
                    eff = eff * 0.5
            else:
                spill = np.zeros(n, dtype=bool)
                for q, k in pairs:
                    spill[(cols.bq == q) & (cols.bkv == k)] = ctx.vmem_spills(
                        q, k
                    )
                eff = np.where(spill, eff * 0.5, eff)
        mb_eff = np.where(n_mb > 1, 1.0 - 0.015 * np.log2(n_mb), 1.0)
        tax = np.where(cols.overlap >= 0.9, 1.05, 1.0)
        compute_s = flops / (chips * hw.peak_flops) / (eff * mb_eff) * tax
        if cfg.is_ssm:
            grid_steps = (
                shape.tokens / np.maximum(dp, 1) / cols.scan_chunk
                * (cfg.d_inner / 256.0)
            )
            compute_s = compute_s + grid_steps * 0.3e-6 / np.maximum(chips / dp, 1)

        # ---- sharded parameter bytes (shared by memory/collectives/capacity)
        g = ctx.param_groups()
        tp_gt1 = tp > 1
        tot = g["mixer"] / np.where(cols.mixer_tp & tp_gt1, tp, 1)
        tot = tot + g["ffn"] / np.where(cols.ffn_tp & tp_gt1, tp, 1)
        if g["moe"]:
            moe_div = np.where(
                cols.moe_ep & tp_gt1, np.minimum(tp, cfg.n_experts),
                np.where(cols.moe_tp & tp_gt1, tp, 1),
            )
            tot = tot + g["moe"] / moe_div
        vs_ok = cfg.vocab_size % mesh.axis("model") == 0  # tp>1 => tp==model ax
        vshard = np.where(cols.vocab_shard & tp_gt1 & vs_ok, tp, 1)
        tot = tot + g["vocab"] / vshard
        tot = tot + g["other"]
        p_tp = tot * BF16

        # ---- memory (HBM traffic, accounted per chip) ----
        weight_reads = p_tp * n_mb * (2 if train else 1)
        ppc = p_tp / BF16 / fsdp  # params per chip (post-FSDP)
        if train:
            sbytes = np.where(cols.opt_int8, _SBYTES_INT8, _SBYTES_F32)
            opt_traffic = ppc * (2 * sbytes + 4)
        else:
            opt_traffic = 0.0
        tl = shape.tokens / dp_eff  # tokens per (batch-limited) data shard
        act_traffic = tl * cfg.d_model * BF16 * cfg.n_layers * (6 if train else 3)
        if train:
            act_traffic = np.where(cols.remat != 0, act_traffic * 1.35, act_traffic)
        if decode:
            kvt = np.empty(n)
            if bool(cols.kv_int8.any()):
                kvt[cols.kv_int8] = ctx.kv_total(1.06)
            if not bool(cols.kv_int8.all()):
                kvt[~cols.kv_int8] = ctx.kv_total(BF16)
            kvt = kvt * ctx.n_periods()
            shard = dp_eff
            seq_mult = (dp // dp_eff) * np.where(~cols.mixer_tp, tp, 1)
            shard = np.where(cols.seq_shard, shard * seq_mult, shard)
            kv_heads = np.minimum(tp, max(cfg.n_kv_heads, 1))
            shard = np.where(cols.mixer_tp & cols.tp_on, shard * kv_heads, shard)
            kv_col = kvt / shard
        else:
            kv_col = 0.0
        per_chip_traffic = weight_reads + opt_traffic + act_traffic + kv_col
        hbm_bytes = per_chip_traffic * chips
        memory_s = per_chip_traffic / hw.hbm_bw

        # ---- collectives ----
        parts = []
        if train:
            shard_bytes = p_tp / fsdp
            ag = shard_bytes * (fsdp - 1)
            rs = ag * _GRAD_SCALE_ZERO3[cols.grad_comm]
            zero3 = (2 * ag + rs) * n_mb
            grad_ar = 2 * p_tp * (dp - 1) / dp * _GRAD_SCALE_AR[cols.grad_comm]
            fsdp_on = fsdp > 1
            param_part = np.where(fsdp_on, zero3, grad_ar)
            pod_part = param_part  # the DP collectives that cross pods
            parts.append(("zero3", fsdp_on, zero3))
            parts.append(("grad_allreduce", ~fsdp_on, grad_ar))
        else:
            wg_mask = cols.tp2d & (fsdp > 1)
            wg = p_tp / fsdp * (fsdp - 1)
            param_part = np.where(wg_mask, wg, 0.0)
            pod_part = np.zeros(n)
            parts.append(("weight_gather", wg_mask, wg))
        act = tl * cfg.d_model * BF16
        n_attn, n_mamba, n_dense, n_moe = ctx.layer_counts()
        n_ar = (
            np.where(cols.mixer_tp, n_attn + n_mamba, 0)
            + np.where(cols.ffn_tp, n_dense, 0)
            + np.where(cols.moe_tp, n_moe, 0)
        ) * ctx.n_periods()
        wire_one = 2 * act * (tp - 1) / tp
        wire_one = np.where(cols.seq_shard, wire_one * 0.5, wire_one)
        tp_act = n_ar * wire_one
        if train:
            tp_act = tp_act * 3
        tp_act = np.where(tp_gt1, tp_act, 0.0)
        parts.append(("tp_act", tp_gt1, tp_act))
        vocab_part = 2 * act * (tp - 1) / tp * (3 if train else 1)
        vocab_mask = tp_gt1 & cols.vocab_shard
        vocab_part = np.where(vocab_mask, vocab_part, 0.0)
        parts.append(("vocab", vocab_mask, vocab_part))
        if cfg.is_moe:
            ep = np.minimum(tp, cfg.n_experts)
            a2a = tl * cfg.experts_per_token * 1.25 * cfg.d_model * BF16
            moe_part = 2 * a2a * (ep - 1) / ep * (3 if train else 1)
            moe_mask = cols.moe_ep & tp_gt1
            moe_part = np.where(moe_mask, moe_part, 0.0)
            parts.append(("moe_a2a", moe_mask, moe_part))
            coll = param_part + tp_act + vocab_part + moe_part
        else:
            coll = param_part + tp_act + vocab_part
        if mesh.multi_pod:
            denom = np.maximum(coll, 1e-9)
            link_eff = (
                (coll - pod_part) / denom * hw.link_bw
                + pod_part / denom * hw.pod_link_bw
            )
            link = np.where(
                cols.pod_data, np.maximum(link_eff, hw.pod_link_bw), hw.link_bw
            )
        else:
            link = hw.link_bw
        collective_s = coll / link

        # ---- capacity ----
        resident = ppc * (sbytes if train else BF16)
        if train:
            tl2 = shape.tokens / dp / n_mb
            tp_vals = set(tp.tolist())
            if len(tp_vals) == 1:
                f_mult, m_mult = ctx.act_mults(next(iter(tp_vals)))
                fm = np.full(n, f_mult)
                mm = np.full(n, m_mult)
            else:
                fm = np.empty(n)
                mm = np.empty(n)
                for v in tp_vals:
                    f_mult, m_mult = ctx.act_mults(v)
                    mask = tp == v
                    fm[mask] = f_mult
                    mm[mask] = m_mult
            d = cfg.d_model
            stored_mult = np.where(
                cols.remat == 2, float(d),
                np.where(cols.remat == 1, d * 4 + mm * 0.5 + fm * 0.5,
                         d * 6 + mm + fm),
            )
            stored = tl2 * stored_mult * ctx.n_periods()
            logits = tl2 * cfg.vocab_size / np.where(cols.vocab_shard, tp, 1)
            logits = np.where(cols.remat == 0, logits, 0.0)
            act_res = stored * BF16 + logits * BF16
        else:
            act_res = 0.0
        per_chip = resident + act_res + kv_col
        feasible = per_chip <= hw.hbm_bytes * 0.92

        step_s = np.maximum(compute_s, memory_s) + (1.0 - cols.overlap) * collective_s
        step_s = np.where(
            feasible, step_s, step_s * (100.0 * (1.0 + per_chip / hw.hbm_bytes))
        )

        n_active = ctx.active_param_count()
        model_flops = (
            6.0 * n_active * shape.tokens if train
            else 2.0 * n_active * shape.tokens
        )
        mfu = model_flops / (step_s * chips * hw.peak_flops)
        return {
            "compute_s": compute_s,
            "memory_s": memory_s,
            "collective_s": collective_s,
            "step_s": step_s,
            "flops": flops,
            "hbm_bytes": hbm_bytes,
            "coll_bytes_per_chip": coll + np.zeros(n),
            "hbm_per_chip": per_chip,
            "feasible": feasible,
            "model_flops": model_flops,
            "eff": eff,
            "mfu": mfu,
            "parts": parts,
        }

    def _assemble_terms(self, out: dict, i: int) -> RooflineTerms:
        """One plan's ``RooflineTerms`` from the kernel's column output —
        the same fields (and the same ``details`` keys, in the same
        insertion order) the scalar path produces."""
        details = {
            name: float(vals[i])
            for name, mask, vals in out["parts"] if mask[i]
        }
        details["eff"] = float(out["eff"][i])
        details["mfu"] = float(out["mfu"][i])
        return RooflineTerms(
            compute_s=float(out["compute_s"][i]),
            memory_s=float(out["memory_s"][i]),
            collective_s=float(out["collective_s"][i]),
            step_s=float(out["step_s"][i]),
            flops=float(out["flops"][i]),
            hbm_bytes=float(out["hbm_bytes"][i]),
            coll_bytes_per_chip=float(out["coll_bytes_per_chip"][i]),
            hbm_per_chip=float(out["hbm_per_chip"][i]),
            feasible=bool(out["feasible"][i]),
            model_flops=float(out["model_flops"]),
            details=details,
        )

    # ------------------------------------------------------------------
    # The jitted kernel (pricing="jit")
    # ------------------------------------------------------------------
    def _step_batch(self, cols: PlanColumns) -> np.ndarray:
        """``step_s`` for an encoded batch through the selected kernel —
        the one dispatch ``cost``/``cost_batch``/``cost_columns`` share, so
        the scalar and batched signals cannot drift within a pricing
        path."""
        if self.pricing == "jit":
            return self._terms_jitted(cols, self._ctx())
        return self._terms_columnar(cols, self._ctx())["step_s"]

    def _terms_jitted(self, cols: PlanColumns, ctx: _EvalContext) -> np.ndarray:
        """``step_s`` for a whole encoded batch through the compiled kernel.

        The discrete, plan-keyed lookups the columnar kernel resolves
        through ``_EvalContext`` (the spill test per flash-block pair,
        activation multipliers per TP degree, KV totals per dtype) are
        gathered host-side into plain numeric columns (``_jit_inputs``);
        everything else is one float64 torch program on ``self.device``.
        The batch crosses to the device as one packed array and comes back
        as one, a host-device round trip a batch.  Agreement with
        ``_terms_columnar``: within ``JIT_RTOL``."""
        fn = self._jit_fn
        if fn is None:
            fn = self._jit_fn = _build_jit_kernel(self, ctx)
        out = fn(**self._jit_inputs(cols, ctx))
        self.n_jit_batches += 1
        return out.cpu().numpy()

    def _jit_inputs(self, cols: PlanColumns, ctx: _EvalContext) -> dict:
        """Host-side gather: the same per-discrete-key context lookups
        ``_terms_columnar`` performs, as float64 columns on ``self.device``
        (integers and flags are exact in float64).  The columns are packed
        into one array, so the batch is one host-to-device copy."""
        import torch

        cfg, shape = self.cfg, self.shape
        n = cols.n
        # the spill test per distinct (bq, bkv) pair, as in the columnar kernel
        spill = np.zeros(n, dtype=bool)
        if cfg.n_heads:
            for q, k in set(zip(cols.bq.tolist(), cols.bkv.tolist())):
                spill[(cols.bq == q) & (cols.bkv == k)] = ctx.vmem_spills(q, k)
        # stored-activation multipliers per distinct TP degree (train only)
        fm = np.zeros(n)
        mm = np.zeros(n)
        if shape.kind == "train":
            tp = np.where(cols.tp_on, self.mesh.axis("model"), 1)
            for v in set(tp.tolist()):
                f_mult, m_mult = ctx.act_mults(int(v))
                fm[tp == v] = f_mult
                mm[tp == v] = m_mult
        # whole-model KV bytes per dtype, before the n_periods multiply
        kvt = np.zeros(n)
        if shape.kind == "decode":
            if bool(cols.kv_int8.any()):
                kvt[cols.kv_int8] = ctx.kv_total(1.06)
            if not bool(cols.kv_int8.all()):
                kvt[~cols.kv_int8] = ctx.kv_total(BF16)
        host = {
            "pod_data": cols.pod_data, "tp_on": cols.tp_on,
            "fsdp_on": cols.fsdp_on, "tp2d": cols.tp2d,
            "mixer_tp": cols.mixer_tp, "seq_shard": cols.seq_shard,
            "ffn_tp": cols.ffn_tp, "moe_ep": cols.moe_ep,
            "moe_tp": cols.moe_tp, "vocab_shard": cols.vocab_shard,
            "opt_int8": cols.opt_int8, "remat": cols.remat,
            "grad_comm": cols.grad_comm, "microbatches": cols.microbatches,
            "bq": cols.bq, "bkv": cols.bkv, "scan_chunk": cols.scan_chunk,
            "overlap": cols.overlap, "spill": spill, "fm": fm, "mm": mm,
            "kvt": kvt,
        }
        packed = torch.from_numpy(np.stack([np.asarray(v, dtype=np.float64)
                                            for v in host.values()]))
        packed = packed.to(self.device)
        out = dict(zip(host, packed.unbind(0)))
        for k in _JIT_FLAGS:
            out[k] = out[k] != 0
        for k in ("remat", "grad_comm"):  # gather indices
            out[k] = out[k].long()
        return out

    # ------------------------------------------------------------------
    def cost(self, plan: SchedulePlan) -> float:
        """Scalar cost (estimated step seconds, with infeasibility penalty).
        Columnar/jit modes route through the same dispatch as
        ``cost_batch`` (a batch of one), so the scalar and batched signals
        cannot drift."""
        if self.columnar:
            self.n_evals += 1
            if self.columnar_min_batch <= 1:
                cols = PlanColumns.from_plans([plan])
                return float(self._step_batch(cols)[0])
            return self._terms_scalar(plan, self._ctx()).step_s
        return self.terms(plan).step_s

    def cost_batch(self, plans) -> List[float]:
        """Batched pricing: ``cost_batch(plans) == [cost(p) for p in plans]``,
        element-for-element and bit-for-bit.

        Columnar mode encodes the unique plans once (``PlanColumns``) and
        prices the whole batch in one vectorized kernel pass
        (``_terms_columnar``); batches smaller than ``columnar_min_batch``
        dispatch to the certified-identical scalar replay instead (column
        dispatch overhead dominates there — see ``__init__``).  Duplicate
        plans inside the batch — common when concurrent MCTS rollouts
        collide on a schedule — are priced once (``n_evals`` counts each
        *unique* evaluation once; values are unaffected).

        ``columnar=False`` replays the pre-columnar protocol: the scalar
        arithmetic per unique plan, with the plan-independent accounting
        amortized through one persistent ``_EvalContext``."""
        if not plans:
            return []
        if self.columnar:
            index: Dict[SchedulePlan, int] = {}
            uniq: List[SchedulePlan] = []
            for p in plans:
                if p not in index:
                    index[p] = len(uniq)
                    uniq.append(p)
            if len(uniq) >= self.columnar_min_batch:
                step = self.cost_columns(PlanColumns.from_plans(uniq))
            else:  # below the kernel crossover: skip the encode entirely
                self.n_evals += len(uniq)
                ctx = self._ctx()
                step = [self._terms_scalar(p, ctx).step_s for p in uniq]
            if len(uniq) == len(plans):
                return step
            return [step[index[p]] for p in plans]
        ctx = self._batch_ctx
        if ctx is None:
            ctx = self._batch_ctx = _EvalContext(self)
        out: List[float] = []
        memo: Dict[SchedulePlan, float] = {}
        for plan in plans:
            c = memo.get(plan)
            if c is None:
                c = memo[plan] = self.terms(plan, ctx).step_s
            out.append(c)
        return out

    def cost_columns(self, cols: PlanColumns) -> List[float]:
        """Price an already-encoded batch — the seam the serving layer
        uses so one ``PlanColumns`` encode feeds either the learned MLP or
        this kernel.  No dedup here: callers hand deduplicated miss
        batches (``CachedMDP``); every column is one evaluation."""
        if not self.columnar:  # oracle mode: the pre-columnar replay
            return self.cost_batch(cols.plans)
        self.n_evals += cols.n
        if cols.n < self.columnar_min_batch:
            ctx = self._ctx()
            return [self._terms_scalar(p, ctx).step_s for p in cols.plans]
        return [float(v) for v in self._step_batch(cols)]

    def partial_cost(self, actions, space: ScheduleSpace) -> float:
        """The (unreliable) cost of an INCOMPLETE schedule: complete the
        remaining stages with defaults (memoized per space) and evaluate —
        this is exactly what beam search must do at every depth, and what
        the paper shows is misleading (Fig. 1/2)."""
        defaults = space.default_actions()
        full = list(actions) + defaults[len(actions):]
        return self.cost(space.plan_from_actions(full))


# the boolean columns of ``_jit_inputs``
_JIT_FLAGS = ("pod_data", "tp_on", "fsdp_on", "tp2d", "mixer_tp", "seq_shard",
              "ffn_tp", "moe_ep", "moe_tp", "vocab_shard", "opt_int8", "spill")


def _build_jit_kernel(model: AnalyticCostModel, ctx: _EvalContext):
    """The compiled ``step_s`` kernel for one (cfg, shape, mesh, hw) cell.

    Every cell-constant quantity (structural FLOP/param accounting, mesh
    axes, hardware numbers, kind flags) is resolved here, through the same
    ``_EvalContext`` the columnar kernel uses, and closed over as Python
    scalars, so the program is pure elementwise column math: the
    ``_terms_columnar`` arithmetic, operation for operation, in float64.
    Integer columns arrive as float64 (exact), so ``a / b`` is the float64
    division numpy performs on the same values.  ``torch.where`` evaluates
    both branches, as ``jnp.where`` does: every division below has a
    divisor that is at least 1 (or ``max(coll, 1e-9)``) in both branches,
    so no inf or nan is made to be discarded.  Only ``step_s`` is computed:
    the compiled path prices searches, and full term breakdowns stay on the
    exact kernels."""
    import torch

    f64 = torch.float64
    dev = torch.device(model.device)
    cfg, shape, hw, mesh = model.cfg, model.shape, model.hw, model.mesh
    train = shape.kind == "train"
    decode = shape.kind == "decode"
    chips = mesh.size
    gbm = max(shape.global_batch, 1)
    mesh_data = mesh.axis("data")
    mesh_model = mesh.axis("model")
    multi_pod = mesh.multi_pod
    mesh_pod = mesh.axis("pod") if multi_pod else 1
    fwd = ctx.fwd_flops()
    param_count = ctx.param_count()
    g = dict(ctx.param_groups())
    n_attn, n_mamba, n_dense, n_moe = ctx.layer_counts()
    n_periods = ctx.n_periods()
    vs_ok = cfg.vocab_size % mesh_model == 0
    n_kv_heads = max(cfg.n_kv_heads, 1)
    has_heads = bool(cfg.n_heads)
    is_ssm, is_moe = cfg.is_ssm, cfg.is_moe
    tokens = shape.tokens
    d_model, d_inner = cfg.d_model, cfg.d_inner
    n_layers, vocab_size = cfg.n_layers, cfg.vocab_size
    n_experts, ept = cfg.n_experts, cfg.experts_per_token
    k_tile = (512.0 / 576.0) ** 2
    remat_mult = torch.tensor(_REMAT_MULT, dtype=f64, device=dev)
    gs_zero3 = torch.tensor(_GRAD_SCALE_ZERO3, dtype=f64, device=dev)
    gs_ar = torch.tensor(_GRAD_SCALE_AR, dtype=f64, device=dev)

    def c(v):  # a float64 scalar on the device: a where() branch
        return torch.tensor(float(v), dtype=f64, device=dev)

    def kernel(pod_data, tp_on, fsdp_on, tp2d, mixer_tp, seq_shard, ffn_tp,
               moe_ep, moe_tp, vocab_shard, opt_int8, remat, grad_comm,
               microbatches, bq, bkv, scan_chunk, overlap, spill, fm, mm,
               kvt):
        # ---- mesh sizes (integers, exact in float64) ----
        dp = torch.full_like(overlap, float(mesh_data))
        if multi_pod:
            dp = torch.where(pod_data, dp * mesh_pod, dp)
        tp = torch.where(tp_on, c(mesh_model), c(1))
        fsdp = torch.where(fsdp_on, dp, c(1))
        n_mb = torch.clamp(microbatches, min=1)
        dp_eff = torch.clamp(dp, max=gbm)

        # ---- compute ----
        if train:
            flops = fwd * remat_mult[remat] + 10.0 * param_count
        else:
            flops = torch.full_like(overlap, float(fwd))
        eff = (bq / (bq + 64.0)) * (bkv / (bkv + 64.0)) / k_tile
        eff = torch.clamp(eff, max=1.0)
        if has_heads:
            eff = torch.where(spill, eff * 0.5, eff)
        mb_eff = torch.where(n_mb > 1, 1.0 - 0.015 * torch.log2(n_mb), c(1.0))
        tax = torch.where(overlap >= 0.9, c(1.05), c(1.0))
        compute_s = flops / (chips * hw.peak_flops) / (eff * mb_eff) * tax
        if is_ssm:
            grid_steps = (
                tokens / torch.clamp(dp, min=1) / scan_chunk * (d_inner / 256.0)
            )
            compute_s = compute_s + grid_steps * 0.3e-6 / torch.clamp(chips / dp, min=1)

        # ---- sharded parameter bytes ----
        tp_gt1 = tp > 1
        tot = g["mixer"] / torch.where(mixer_tp & tp_gt1, tp, c(1))
        tot = tot + g["ffn"] / torch.where(ffn_tp & tp_gt1, tp, c(1))
        if g["moe"]:
            moe_div = torch.where(
                moe_ep & tp_gt1, torch.clamp(tp, max=n_experts),
                torch.where(moe_tp & tp_gt1, tp, c(1)),
            )
            tot = tot + g["moe"] / moe_div
        vs_mask = (vocab_shard & tp_gt1) if vs_ok else torch.zeros_like(tp_gt1)
        tot = tot + g["vocab"] / torch.where(vs_mask, tp, c(1))
        tot = tot + g["other"]
        p_tp = tot * BF16

        # ---- memory (HBM traffic, accounted per chip) ----
        weight_reads = p_tp * n_mb * (2 if train else 1)
        ppc = p_tp / BF16 / fsdp
        if train:
            sbytes = torch.where(opt_int8, c(_SBYTES_INT8), c(_SBYTES_F32))
            opt_traffic = ppc * (2 * sbytes + 4)
        else:
            opt_traffic = 0.0
        tl = tokens / dp_eff
        act_traffic = tl * d_model * BF16 * n_layers * (6 if train else 3)
        if train:
            act_traffic = torch.where(remat != 0, act_traffic * 1.35, act_traffic)
        if decode:
            kvt_full = kvt * n_periods
            shard = dp_eff
            seq_mult = torch.div(dp, dp_eff, rounding_mode="floor") * torch.where(
                ~mixer_tp, tp, c(1))
            shard = torch.where(seq_shard, shard * seq_mult, shard)
            kv_heads = torch.clamp(tp, max=n_kv_heads)
            shard = torch.where(mixer_tp & tp_on, shard * kv_heads, shard)
            kv_col = kvt_full / shard
        else:
            kv_col = 0.0
        per_chip_traffic = weight_reads + opt_traffic + act_traffic + kv_col
        memory_s = per_chip_traffic / hw.hbm_bw

        # ---- collectives ----
        if train:
            shard_bytes = p_tp / fsdp
            ag = shard_bytes * (fsdp - 1)
            rs = ag * gs_zero3[grad_comm]
            zero3 = (2 * ag + rs) * n_mb
            grad_ar = 2 * p_tp * (dp - 1) / dp * gs_ar[grad_comm]
            param_part = torch.where(fsdp > 1, zero3, grad_ar)
            pod_part = param_part
        else:
            wg_mask = tp2d & (fsdp > 1)
            wg = p_tp / fsdp * (fsdp - 1)
            param_part = torch.where(wg_mask, wg, c(0.0))
            pod_part = torch.zeros_like(param_part)
        act = tl * d_model * BF16
        n_ar = (
            torch.where(mixer_tp, c(n_attn + n_mamba), c(0))
            + torch.where(ffn_tp, c(n_dense), c(0))
            + torch.where(moe_tp, c(n_moe), c(0))
        ) * n_periods
        wire_one = 2 * act * (tp - 1) / tp
        wire_one = torch.where(seq_shard, wire_one * 0.5, wire_one)
        tp_act = n_ar * wire_one
        if train:
            tp_act = tp_act * 3
        tp_act = torch.where(tp_gt1, tp_act, c(0.0))
        vocab_part = 2 * act * (tp - 1) / tp * (3 if train else 1)
        vocab_part = torch.where(tp_gt1 & vocab_shard, vocab_part, c(0.0))
        coll = param_part + tp_act + vocab_part
        if is_moe:
            ep = torch.clamp(tp, max=n_experts)
            a2a = tl * ept * 1.25 * d_model * BF16
            moe_part = 2 * a2a * (ep - 1) / ep * (3 if train else 1)
            coll = coll + torch.where(moe_ep & tp_gt1, moe_part, c(0.0))
        if multi_pod:
            denom = torch.clamp(coll, min=1e-9)
            link_eff = (
                (coll - pod_part) / denom * hw.link_bw
                + pod_part / denom * hw.pod_link_bw
            )
            link = torch.where(
                pod_data, torch.clamp(link_eff, min=hw.pod_link_bw), c(hw.link_bw)
            )
        else:
            link = hw.link_bw
        collective_s = coll / link

        # ---- capacity ----
        resident = ppc * (sbytes if train else BF16)
        if train:
            tl2 = tokens / dp / n_mb
            stored_mult = torch.where(
                remat == 2, c(d_model),
                torch.where(remat == 1, d_model * 4 + mm * 0.5 + fm * 0.5,
                            d_model * 6 + mm + fm),
            )
            stored = tl2 * stored_mult * n_periods
            logits = tl2 * vocab_size / torch.where(vocab_shard, tp, c(1))
            logits = torch.where(remat == 0, logits, c(0.0))
            act_res = stored * BF16 + logits * BF16
        else:
            act_res = 0.0
        per_chip = resident + act_res + kv_col
        feasible = per_chip <= hw.hbm_bytes * 0.92

        step_s = torch.maximum(compute_s, memory_s) + (1.0 - overlap) * collective_s
        return torch.where(
            feasible, step_s,
            step_s * (100.0 * (1.0 + per_chip / hw.hbm_bytes)),
        )

    return kernel
