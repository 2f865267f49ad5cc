"""The schedule space: ProTuner's MDP states/actions, for the port.

The paper schedules a Halide pipeline stage-by-stage (tiling, vectorize,
parallel, compute-at).  Here a *schedule* is the complete set of distribution
and kernel decisions for one (architecture × input-shape × mesh) cell; the
MDP assigns one decision **stage** at a time, in a fixed order, so a state is
a prefix of decisions and a terminal state is a complete ``SchedulePlan`` —
only terminal states are costed, exactly as in the paper.

A copy of the JAX package's ``core/space.py`` with the hardware made a
parameter (``hw``, a ``core.hardware.HardwareSpec``):

* meshes per hardware (``MESHES``): the TPU's 16×16 and 2×16×16 pods under
  ``tpu-v5e``; under the H100, one NVLink domain of 8 GPUs (``single``, 1×8),
  two such nodes across InfiniBand (``multi``, 2×1×8) and the one card a
  machine of the port's runs has (``card``, 1×1);
* the kernel-tile options (``attn_block``, ``scan_chunk``): the TPU's under
  ``tpu-v5e``; under the H100 the tiles the port's kernels launch for the
  cell's arch (``kernels.geometry``), so a tuned plan's tile always launches;
* ``_plan_defaults``' "too big to replicate" threshold is half the device
  memory, ``hw.hbm_bytes / 2`` (the JAX package's ``8 * 2**30`` on a v5e).

Under ``tpu-v5e`` every stage, option and default is the JAX package's, so
the search's results are too (``tests/test_torch_search.py``).

Stages that are inapplicable to a cell (``moe_mode`` on a dense arch,
``microbatches`` on a decode shape) collapse to their single legal action, so
every cell presents a well-formed MDP.
"""
from __future__ import annotations

import dataclasses
import itertools
import random as _random
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.core.hardware import H100, TPU_V5E, HardwareSpec, get_hardware
from repro_torch.kernels.geometry import launchable_attn_blocks, launchable_scan_chunks


@dataclass(frozen=True)
class MeshSpec:
    """Abstract mesh: axis names + sizes (no jax device state needed)."""

    names: Tuple[str, ...]
    shape: Tuple[int, ...]

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    def axis(self, name: str) -> int:
        return self.shape[self.names.index(name)]

    @property
    def multi_pod(self) -> bool:
        return "pod" in self.names


SINGLE_POD = MeshSpec(("data", "model"), (16, 16))
MULTI_POD = MeshSpec(("pod", "data", "model"), (2, 16, 16))
# H100: one NVLink domain of 8 GPUs (the model axis inside it), two such
# nodes across InfiniBand, and one card
H100_NODE = MeshSpec(("data", "model"), (1, 8))
H100_TWO_NODES = MeshSpec(("pod", "data", "model"), (2, 1, 8))
ONE_CARD = MeshSpec(("data", "model"), (1, 1))

# mesh names by hardware spec name
MESHES: Dict[str, Dict[str, MeshSpec]] = {
    TPU_V5E.name: {"single": SINGLE_POD, "multi": MULTI_POD},
    H100.name: {"single": H100_NODE, "multi": H100_TWO_NODES, "card": ONE_CARD},
}


def get_mesh(hw, mesh: str) -> MeshSpec:
    """The ``MeshSpec`` a mesh name stands for on hardware ``hw``."""
    meshes = MESHES[get_hardware(hw).name]
    if mesh not in meshes:
        raise KeyError(f"unknown mesh {mesh!r} for {get_hardware(hw).name}; known: {list(meshes)}")
    return meshes[mesh]


@dataclass(frozen=True)
class SchedulePlan:
    """A complete schedule: one value per stage."""

    batch_axes: str = "data"  # "data" | "pod_data"
    param_strategy: str = "fsdp_tp"  # replicated | tp | fsdp | fsdp_tp
    mixer_tp: bool = True  # shard attention heads / mamba d_inner over model
    seq_shard: bool = False  # sequence-parallel activations / KV-cache seq
    ffn_tp: bool = True
    moe_mode: str = "dense"  # ep | tp | dense (dense = replicated experts)
    vocab_shard: bool = True
    remat: str = "dots"  # none | dots | full
    microbatches: int = 1
    attn_block: Tuple[int, int] = (256, 256)  # flash (block_q, block_kv)
    scan_chunk: int = 128  # mamba time chunk
    grad_comm: str = "fp32"  # fp32 | int8 | rs_ag
    overlap: float = 0.5  # collective/compute overlap factor
    opt_dtype: str = "float32"  # float32 | int8 Adam moments
    kv_dtype: str = "bf16"  # bf16 | int8 KV cache (decode shapes)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "SchedulePlan":
        d = dict(d)
        if isinstance(d.get("attn_block"), list):
            d["attn_block"] = tuple(d["attn_block"])
        return SchedulePlan(**d)


@dataclass(frozen=True)
class Stage:
    name: str
    options: Tuple


def attn_block_options(cfg: ModelConfig, hw: HardwareSpec) -> Tuple[Tuple[int, int], ...]:
    """The ``attn_block`` options on ``hw``: the TPU's nine, or on the H100
    those the port's flash kernel launches at the arch's head_dim and dtype."""
    if hw.name == TPU_V5E.name:
        return tuple(itertools.product((128, 256, 512), (128, 256, 512)))
    if hw.name == H100.name:
        opts = tuple(launchable_attn_blocks(cfg.resolved_head_dim, cfg.dtype))
        if not opts:
            raise ValueError(f"{cfg.name}: no attn_block launches at head_dim "
                             f"{cfg.resolved_head_dim} in {cfg.dtype}")
        return opts
    raise ValueError(f"no attn_block options for hardware {hw.name!r}")


def scan_chunk_options(cfg: ModelConfig, hw: HardwareSpec) -> Tuple[int, ...]:
    """The ``scan_chunk`` options on ``hw``: the TPU's three, or on the H100
    those the port's scan kernel launches at ``d_block`` 256 and the arch's
    state size and dtype (the kernel still asserts that a chunk divides
    the sequence, as the JAX kernel does)."""
    if hw.name == TPU_V5E.name:
        return (64, 128, 256)
    if hw.name == H100.name:
        opts = tuple(launchable_scan_chunks(256, cfg.ssm_state, cfg.dtype))
        if not opts:
            raise ValueError(f"{cfg.name}: no scan_chunk launches at N={cfg.ssm_state} "
                             f"in {cfg.dtype}")
        return opts
    raise ValueError(f"no scan_chunk options for hardware {hw.name!r}")


class ScheduleSpace:
    """Per-cell stage list; builds plans from action sequences."""

    def __init__(self, cfg: ModelConfig, shape: InputShape, mesh: MeshSpec,
                 hw: HardwareSpec = H100):
        self.cfg = cfg
        self.shape = shape
        self.mesh = mesh
        self.hw = hw
        self.stages: List[Stage] = self._build_stages()
        self._default_actions: Optional[List[int]] = None

    # -- MDP geometry --------------------------------------------------------
    def _build_stages(self) -> List[Stage]:
        cfg, shape, mesh = self.cfg, self.shape, self.mesh
        train = shape.kind == "train"
        st: List[Stage] = []

        st.append(
            Stage(
                "batch_axes",
                ("data", "pod_data") if mesh.multi_pod else ("data",),
            )
        )
        if train:
            st.append(Stage("param_strategy", ("replicated", "tp", "fsdp", "fsdp_tp")))
        else:
            # inference: no optimizer state; "tp2d" shards weights over BOTH
            # mesh axes (gather-on-use) — required for ≥70B archs and for
            # batch-1 long-context decode where the data axis is idle.
            st.append(Stage("param_strategy", ("replicated", "tp", "tp2d")))
        if cfg.is_attention_free or cfg.n_heads > 0:
            st.append(Stage("mixer_tp", (False, True)))
        st.append(Stage("seq_shard", (False, True)))
        st.append(Stage("ffn_tp", (False, True) if cfg.d_ff else (False,)))
        st.append(
            Stage("moe_mode", ("ep", "tp", "dense") if cfg.is_moe else ("dense",))
        )
        st.append(Stage("vocab_shard", (False, True)))
        st.append(Stage("remat", ("none", "dots", "full") if train else ("none",)))
        st.append(
            Stage(
                "microbatches",
                (1, 2, 4, 8, 16) if train else (1,),
            )
        )
        if cfg.n_heads > 0 and shape.kind != "decode":
            st.append(Stage("attn_block", attn_block_options(cfg, self.hw)))
        if cfg.is_ssm and shape.kind != "decode":
            st.append(Stage("scan_chunk", scan_chunk_options(cfg, self.hw)))
        if shape.kind == "decode" and cfg.n_heads > 0:
            st.append(Stage("kv_dtype", ("bf16", "int8")))
        if train:
            st.append(Stage("grad_comm", ("fp32", "int8", "rs_ag")))
        st.append(Stage("overlap", (0.0, 0.5, 0.9)))
        if train:
            st.append(Stage("opt_dtype", ("float32", "int8")))
        return st

    @property
    def n_stages(self) -> int:
        return len(self.stages)

    def n_complete(self) -> int:
        n = 1
        for s in self.stages:
            n *= len(s.options)
        return n

    def n_actions(self, depth: int) -> int:
        return len(self.stages[depth].options)

    # -- plan construction ---------------------------------------------------
    def plan_from_actions(self, actions: Sequence[int]) -> SchedulePlan:
        assert len(actions) == self.n_stages, (len(actions), self.n_stages)
        kv = {
            s.name: s.options[a] for s, a in zip(self.stages, actions)
        }
        return SchedulePlan(**{**_plan_defaults(self), **kv})

    def default_actions(self) -> List[int]:
        """The paper-faithful baseline plan's action indices (a sane default
        schedule, analogous to Halide's master autoscheduler output).

        Memoized per space and returned by reference: the default
        completion is the hot constant of every ``partial_cost`` — beam
        and greedy sweeps call it at every depth — so rebuilding the
        default ``SchedulePlan`` per call was pure overhead.  Treat the
        returned list as read-only (every in-repo caller copies via
        slicing/concatenation)."""
        if self._default_actions is None:
            base = _plan_defaults(self)
            default = SchedulePlan(**base)
            out = []
            for s in self.stages:
                want = getattr(default, s.name)
                out.append(s.options.index(want) if want in s.options else 0)
            self._default_actions = out
        return self._default_actions

    def random_actions(self, rng: _random.Random) -> List[int]:
        return [rng.randrange(len(s.options)) for s in self.stages]

    def random_plan(self, rng: _random.Random) -> SchedulePlan:
        return self.plan_from_actions(self.random_actions(rng))


def _plan_defaults(space: ScheduleSpace) -> dict:
    """Values for stages absent from this cell's MDP (single legal action)."""
    cfg, shape, mesh = space.cfg, space.shape, space.mesh
    train = shape.kind == "train"
    # big models can't replicate the model axis at inference: default to 2D
    big = cfg.param_count() * 2 / mesh.axis("model") > space.hw.hbm_bytes / 2
    small_batch = shape.global_batch < mesh.axis("data")
    return dict(
        batch_axes="pod_data" if mesh.multi_pod else "data",
        param_strategy="fsdp_tp" if train else ("tp2d" if (big or small_batch) else "tp"),
        mixer_tp=True,
        ffn_tp=bool(cfg.d_ff),
        moe_mode="ep" if cfg.is_moe else "dense",
        vocab_shard=True,
        remat="dots" if train else "none",
        microbatches=8 if train else 1,
        seq_shard=bool(not train and small_batch),
        attn_block=(256, 256),
        scan_chunk=128,
        grad_comm="fp32",
        overlap=0.5,
        opt_dtype="float32",
        kv_dtype="bf16",
    )
