"""Checkpoints: save/restore of the parameter and optimizer trees, async
writes, keep-N garbage collection.

The counterpart of the JAX package's ``checkpoint/ckpt.py`` on one device.
Format: ``step_<n>.pt``, a ``torch.save`` of the flat state (``"/"``-joined
tree paths to CPU tensors; an integer leaf such as the optimizer step is
stored as a 0-dim tensor), and ``step_<n>.json``, a manifest with the step,
the caller's ``extra`` and each leaf's dtype and shape.  Both are written to
a temporary file and renamed into place, the manifest first; a step counts
as saved once its ``.pt`` exists.  The state is copied to host memory before
``save`` returns, so an async write never sees a later in-place update.
Restore loads with ``weights_only=True`` onto the template's device and
dtype; the template also tells which leaves are Python integers.

Elastic over meshes (the JAX package's restore under other shardings):
given ``par`` (a ``sharding.parallel.ParallelContext``), ``save`` gathers
the rank's shards into whole leaves (every rank takes part) and rank 0
writes them in the one-device format, with the mesh in the manifest;
``restore`` has every rank load the whole leaves and keep its shard under
``par``'s rules, whatever mesh wrote them.  So a one-card checkpoint
restores onto a mesh, and a mesh's onto one card.
"""
from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, Optional, Tuple

import torch


def _flatten(tree: dict, prefix: str = "") -> Dict[str, Any]:
    flat = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            flat.update(_flatten(v, path + "/"))
        else:
            flat[path] = v
    return flat


def _unflatten_like(template: dict, flat: Dict[str, torch.Tensor], prefix: str = "") -> dict:
    out = {}
    for k, leaf in template.items():
        path = f"{prefix}{k}"
        if isinstance(leaf, dict):
            out[k] = _unflatten_like(leaf, flat, path + "/")
            continue
        arr = flat[path]
        if isinstance(leaf, int):
            out[k] = int(arr)
            continue
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"checkpoint leaf {path} is {tuple(arr.shape)}, expected {tuple(leaf.shape)}")
        out[k] = arr.to(device=leaf.device, dtype=leaf.dtype)
    return out


def _unflatten_paths(flat: Dict[str, Any]) -> dict:
    out: dict = {}
    for path, v in flat.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def _to_host(v) -> torch.Tensor:
    if isinstance(v, int):
        return torch.tensor(v, dtype=torch.int64)
    return v.detach().to("cpu", copy=True)


def _opt_specs(opt_state, par):
    from repro_torch.training.optimizer import opt_state_pspecs

    return opt_state_pspecs(opt_state, par.specs)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._async_thread: Optional[threading.Thread] = None
        self._async_error: Optional[Exception] = None

    def _base(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    # -- save --------------------------------------------------------------------
    def save(
        self,
        step: int,
        params: dict,
        opt_state: Optional[dict] = None,
        extra: Optional[dict] = None,
        blocking: bool = True,
        par=None,
    ) -> str:
        """Write ``step``; under ``par`` every rank calls it with its shards
        and rank 0 writes."""
        if par is not None:
            from repro_torch.sharding.parallel import gather_tree

            params = gather_tree(params, par.specs, par.mesh)
            if opt_state is not None:
                opt_state = gather_tree(opt_state, _opt_specs(opt_state, par), par.mesh)
        state = {"params": params}
        if opt_state is not None:
            state["opt"] = opt_state
        path = self._base(step)
        if par is not None and par.mesh.rank != 0:
            return path
        flat = {k: _to_host(v) for k, v in _flatten(state).items()}
        meta = {
            "step": step,
            "extra": extra or {},
            "mesh": None if par is None else {"names": list(par.mesh.spec.names),
                                              "shape": list(par.mesh.spec.shape)},
            "leaves": {k: {"dtype": str(v.dtype), "shape": list(v.shape)} for k, v in flat.items()},
        }

        def _write():
            with open(path + ".json.tmp", "w") as f:
                json.dump(meta, f)
            os.replace(path + ".json.tmp", path + ".json")
            torch.save(flat, path + ".pt.tmp")
            os.replace(path + ".pt.tmp", path + ".pt")
            self._gc()

        def _write_async():
            try:
                _write()
            except Exception as e:  # re-raised by wait()
                self._async_error = e

        if blocking:
            _write()
        else:
            self.wait()  # at most one async save in flight
            self._async_thread = threading.Thread(target=_write_async, daemon=True)
            self._async_thread.start()
        return path

    def wait(self) -> None:
        """Join the async save in flight, if any; raise what it raised."""
        if self._async_thread is not None:
            self._async_thread.join()
            self._async_thread = None
        if self._async_error is not None:
            err, self._async_error = self._async_error, None
            raise err

    def _gc(self) -> None:
        for step in self.list_steps()[: -self.keep]:
            for ext in (".pt", ".json"):
                try:
                    os.remove(self._base(step) + ext)
                except FileNotFoundError:
                    pass

    # -- restore -----------------------------------------------------------------
    def list_steps(self):
        return sorted(
            int(f[5:-3]) for f in os.listdir(self.dir) if f.startswith("step_") and f.endswith(".pt")
        )

    def latest_step(self) -> Optional[int]:
        steps = self.list_steps()
        return steps[-1] if steps else None

    def restore(
        self, template_params: dict, template_opt: Optional[dict] = None, step: Optional[int] = None,
        par=None,
    ) -> Tuple[dict, Optional[dict], int, dict]:
        """``(params, opt_state, step, extra)`` of ``step`` (the latest by
        default), placed like the templates; under ``par`` the templates are
        this rank's shards, and so is what it returns."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        base = self._base(step)
        with open(base + ".json") as f:
            meta = json.load(f)
        flat = torch.load(base + ".pt", map_location="cpu", weights_only=True)
        if par is not None:
            from repro_torch.sharding.parallel import shard_tree

            specs = {"params": par.specs}
            if template_opt is not None:
                specs["opt"] = _opt_specs(template_opt, par)
            whole = _unflatten_paths(flat)
            flat = _flatten(shard_tree({k: whole[k] for k in specs}, specs, par.mesh, device="cpu"))
        template = {"params": template_params}
        if template_opt is not None:
            template["opt"] = template_opt
        state = _unflatten_like(template, flat)
        return state["params"], state.get("opt"), int(meta["step"]), meta.get("extra", {})
