"""Training loop: data pipeline + train step + checkpoints + fault tolerance.

The counterpart of the JAX package's ``training/trainer.py``.  Given a
mesh (``launch.mesh.Mesh``) each rank runs a ``Trainer``: it draws the
seed's whole weights on its device, keeps its shards, runs the mesh step on
the global batch (of which the step takes its rows), saves and restores its
shards through the elastic checkpoint, and only rank 0 logs.  Each step's
batch comes from the stateless synthetic pipeline as numpy and is moved to
the device; one step is timed on the host clock up to
``torch.cuda.synchronize()`` on the card (where the JAX loop waits on
``block_until_ready``), so the time is the device's, not the enqueue's.
"""
from __future__ import annotations

import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from repro_torch.checkpoint.ckpt import Checkpointer
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.core.space import SchedulePlan
from repro_torch.data.pipeline import DataConfig, Pipeline
from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.runtime.fault_tolerance import HeartbeatMonitor, StragglerPolicy, plan_restart
from repro_torch.training import optimizer as optim
from repro_torch.training.train_step import make_train_step, shard_params


def _default_ckpt_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


@dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = field(default_factory=_default_ckpt_dir)
    ckpt_async: bool = True
    log_every: int = 10
    seed: int = 0


class Trainer:
    def __init__(
        self,
        cfg: ModelConfig,
        shape: InputShape,
        plan: SchedulePlan,
        tc: Optional[TrainerConfig] = None,
        opt_cfg: Optional[optim.OptimizerConfig] = None,
        data_cfg: DataConfig = DataConfig(),
        mesh=None,
        device="cuda",
    ):
        tc = tc or TrainerConfig()
        self.cfg, self.shape, self.plan, self.tc = cfg, shape, plan, tc
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self.opt_cfg = opt_cfg or optim.OptimizerConfig(
            total_steps=tc.total_steps, moment_dtype=plan.opt_dtype
        )
        self.pipe = Pipeline(cfg, shape, data_cfg)
        self.ckpt = Checkpointer(tc.ckpt_dir)
        self.step_fn = make_train_step(cfg, shape, plan, self.opt_cfg, mesh, self.device)
        # a mesh's rank holds shards and checkpoints them elastically; one
        # device keeps its whole leaves as they are
        self.par = self.step_fn.par if mesh is not None else None
        self.metrics_log: List[Dict] = []
        self.monitor: Optional[HeartbeatMonitor] = None
        self.stragglers = StragglerPolicy()

    # -- state ------------------------------------------------------------------
    def init_state(self):
        params = transformer.init_params(self.cfg, self.tc.seed, device=self.device)
        if self.par is not None:
            params = shard_params(params, self.par)
        opt_state = optim.init_opt_state(params, self.opt_cfg, self.par)
        return params, opt_state, 0

    def restore_or_init(self):
        params, opt_state, step = self.init_state()
        if self.ckpt.latest_step() is not None:
            params, opt_state, step, _ = self.ckpt.restore(params, opt_state, par=self.par)
        return params, opt_state, step

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        """The pipeline's batch ``step`` on the device: ids and positions as
        int64, an embeddings arch's stub frontend vectors as they are (f32)."""
        return {
            k: torch.from_numpy(v).to(self.device, dtype=torch.long if v.dtype.kind in "iu" else None)
            for k, v in self.pipe.batch_at(step).items()
        }

    # -- loop --------------------------------------------------------------------
    def run(self, params=None, opt_state=None, start_step: Optional[int] = None):
        if params is None:
            params, opt_state, start_step = self.restore_or_init()
        step = start_step or 0
        host = f"host{self.pipe.dc.host_index}"
        while step < self.tc.total_steps:
            t0 = time.perf_counter()
            params, opt_state, m = self.step_fn(params, opt_state, self.batch_at(step))
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)  # honest step timing (async launches)
            dt = time.perf_counter() - t0
            self.stragglers.observe(host, dt)
            if self.monitor is not None:
                self.monitor.beat(host)
            step += 1
            if (step % self.tc.log_every == 0 or step == 1) and self.step_fn.par.mesh.rank == 0:
                self.metrics_log.append({
                    "step": step,
                    "loss": float(m["loss"]),
                    "grad_norm": float(m["grad_norm"]),
                    "lr": float(m["lr"]),
                    "step_time_s": dt,
                })
            if step % self.tc.ckpt_every == 0:
                self.ckpt.save(
                    step, params, opt_state,
                    extra={"data_step": step},
                    blocking=not self.tc.ckpt_async, par=self.par,
                )
        self.ckpt.wait()
        return params, opt_state, step

    # -- failure handling (exercised by tests and the fleet coordinator) ---------
    def handle_failure(self, alive_hosts, chips_per_host: int, model_parallel: int):
        """On node loss: the elastic restart plan from the last checkpoint; the
        pipeline's stateless indexing makes the re-sharded resume exact."""
        latest = self.ckpt.latest_step() or 0
        return plan_restart(
            alive_hosts, chips_per_host, model_parallel, latest, self.shape.global_batch,
        )
