"""What the ranks of a CPU gloo mesh run for the port's distribution tests.

``launch.mesh.run_on_mesh`` spawns one process per rank and imports the
function it runs from here by name, so this module imports no JAX: a rank
pays for torch alone.  Each function returns plain data (rank 0 the whole
trees, every rank its local shapes)."""
import contextlib
import dataclasses

import numpy as np
import torch

from repro_torch import convert
from repro_torch.checkpoint.ckpt import Checkpointer
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.core.space import SchedulePlan
from repro_torch.kernels import ops
from repro_torch.models import moe, transformer
from repro_torch.sharding import collectives as cc
from repro_torch.sharding.parallel import ParallelContext, gather_tree, shard_tree
from repro_torch.sharding.rules import PartitionSpec, ShardingRules
from repro_torch.training import optimizer as optim
from repro_torch.training.grad_compress import compressed_psum
from repro_torch.training.train_step import (
    gather_opt_state, gather_params, make_positions, make_prefill_step, make_serve_step,
    make_train_step, shard_params,
)


def batch_for(cfg, B: int, S: int, seed: int = 0) -> dict:
    """The global batch of a case: token ids drawn with numpy."""
    tok = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))
    tok = torch.from_numpy(tok)
    return {"inputs": tok, "labels": tok, "positions": make_positions(cfg, B, S, device="cpu")}


def _leaf_shapes(tree: dict) -> dict:
    """Dotted path -> local shape; an int8 moment's codes and scales apart."""
    out = {}
    for path, t in optim.leaves(tree):
        if isinstance(t, dict):
            out.update({f"{path}.{k}": tuple(v.shape) for k, v in t.items()})
        elif isinstance(t, torch.Tensor):
            out[path] = tuple(t.shape)
    return out


def train_cases(mesh, cases: list, trees: dict, ckpt_dir=None) -> list:
    """Each case (``arch``, ``plan`` kwargs, ``opt_dtype``, ``B``, ``S``):
    the prefill logits, the mesh step's gradients, one update and its
    metrics (from the weights in ``trees``, whole, as numpy), and this
    rank's local shapes; the first case is also saved to ``ckpt_dir`` after
    its update."""
    torch.manual_seed(0)
    out = []
    for i, case in enumerate(cases):
        cfg = get_config(case["arch"]).reduced()
        plan = SchedulePlan(**case["plan"])
        oc = optim.OptimizerConfig(peak_lr=1e-3, warmup_steps=0, moment_dtype=case["opt_dtype"])
        step = make_train_step(cfg, None, plan, oc, mesh=mesh)
        par = step.par
        params = shard_params(convert.params_from_numpy(trees[case["arch"]], cfg, device="cpu"), par)
        opt = optim.init_opt_state(params, oc, par)
        batch = batch_for(cfg, case["B"], case["S"])
        logits = make_prefill_step(cfg, None, plan, mesh=mesh)(params, batch)
        logits = cc.all_gather_raw(logits, mesh, par.batch_axes, 0)
        loss, grads = step.loss_and_grads(params, batch)
        grads = gather_params(optim.tree_from_leaves(params, grads), par)
        params, opt, metrics = step(params, opt, batch)
        res = {
            "local_params": _leaf_shapes(params),
            "local_opt": {k: _leaf_shapes(opt[k]) for k in ("mu", "nu")},
            "row_split": sorted(p for p in par.flat_specs if par.row_axes(p)),
            "moe_ep": par.moe_ep,
        }
        whole_params, whole_opt = gather_params(params, par), gather_opt_state(opt, par)
        if ckpt_dir is not None and i == 0:
            Checkpointer(ckpt_dir).save(7, params, opt, extra={"case": 0}, par=par)
        if mesh.rank == 0:
            res.update(loss=float(loss), metrics={k: float(v) for k, v in metrics.items()},
                       grads=grads, params=whole_params, opt=whole_opt, logits=logits)
        out.append(res)
    return out


def mesh_run(mesh, cases: list, trees: dict, ckpt_dir=None, restores=(), trainer_dir=None) -> dict:
    """``train_cases``, ``restore_case`` of each ``(case, dir)`` of
    ``restores`` and, given ``trainer_dir``, ``trainer_case``, in one spawn
    of the mesh."""
    return {"train": train_cases(mesh, cases, trees, ckpt_dir),
            "restore": [restore_case(mesh, case, d) for case, d in restores],
            "trainer": trainer_case(mesh, trainer_dir) if trainer_dir else None}


TRAINER_CASE = dict(arch="granite-3-2b", plan=dict(param_strategy="fsdp_tp", microbatches=2,
                                                   remat="none", seq_shard=True), B=4, S=16)


def trainer_case(mesh, ckpt_dir, steps: int = 2) -> dict:
    """``Trainer`` of ``TRAINER_CASE`` for ``steps`` steps with a checkpoint
    each step: on a mesh (``mesh`` given) or in one process (None)."""
    from repro_torch.configs.base import InputShape
    from repro_torch.training.trainer import Trainer, TrainerConfig

    cfg = get_config(TRAINER_CASE["arch"]).reduced()
    shape = InputShape("t", TRAINER_CASE["S"], TRAINER_CASE["B"], "train")
    tc = TrainerConfig(total_steps=steps, ckpt_every=1, ckpt_dir=ckpt_dir, ckpt_async=False,
                       log_every=1)
    oc = optim.OptimizerConfig(peak_lr=1e-3, warmup_steps=0, total_steps=steps)
    tr = Trainer(cfg, shape, SchedulePlan(**TRAINER_CASE["plan"]), tc, opt_cfg=oc, mesh=mesh,
                 device="cpu")
    params, opt, step = tr.run()
    if mesh is not None:
        params = gather_params(params, tr.par)
    return {"log": [{k: r[k] for k in ("step", "loss", "grad_norm")} for r in tr.metrics_log],
            "step": step, "params": params}


def restore_case(mesh, case: dict, ckpt_dir: str) -> dict:
    """Restore ``ckpt_dir``'s latest step onto this mesh under ``case``'s
    plan; the restored shards gathered back whole, and the local shapes."""
    cfg = get_config(case["arch"]).reduced()
    plan = SchedulePlan(**case["plan"])
    oc = optim.OptimizerConfig(moment_dtype=case["opt_dtype"])
    par = make_train_step(cfg, None, plan, oc, mesh=mesh).par
    from repro_torch.models import transformer

    tmpl = shard_params(transformer.init_params(cfg, 1, device="cpu"), par)
    tmpl_opt = optim.init_opt_state(tmpl, oc, par)
    params, opt, step, extra = Checkpointer(ckpt_dir).restore(tmpl, tmpl_opt, par=par)
    return {"step": step, "extra": extra, "local_params": _leaf_shapes(params),
            "local_opt": {k: _leaf_shapes(opt[k]) for k in ("mu", "nu")},
            "params": gather_params(params, par), "opt": gather_opt_state(opt, par)}


def ep_cases(mesh, cases: list) -> list:
    """The expert-parallel MoE forward and its gradients on this mesh for
    each case (``arch``, ``act``, ``fsdp``, weights ``p``, input ``x`` and
    cotangent ``r``, whole): rank 0 returns the whole output and gradients."""
    import dataclasses

    out = []
    for case in cases:
        cfg = dataclasses.replace(get_config(case["arch"]).reduced(), act=case["act"])
        plan = SchedulePlan(param_strategy="fsdp_tp" if case["fsdp"] else "tp", moe_mode="ep")
        rules = ShardingRules(cfg, None, plan, mesh.spec)
        whole = {k: torch.from_numpy(np.array(v)) for k, v in case["p"].items()}
        specs = rules.param_pspecs({"mlp": whole})
        ctx = ParallelContext(mesh, specs, {"mlp": {k: v.shape for k, v in whole.items()}},
                              batch_axes=rules.batch, moe_ep=True)
        p = shard_tree({"mlp": whole}, specs, mesh)["mlp"]
        for t in p.values():
            t.requires_grad_(True)
        dp, b = ctx.dp, mesh.index(ctx.batch_axes)
        x = torch.from_numpy(np.array(case["x"]))
        r = torch.from_numpy(np.array(case["r"]))
        rows = x.shape[0] // dp
        x_loc = x[b * rows:(b + 1) * rows].clone().requires_grad_(True)
        y = moe.forward(p, cfg, x_loc, tiles=ops.DEFAULT_TILES, par=ctx.view("mlp"))
        loss = (y * r[b * rows:(b + 1) * rows]).sum()
        loss.backward()
        grads = {k: t.grad for k, t in p.items()}
        ctx.reduce_batch_grads({f"mlp.{k}": g for k, g in grads.items()})
        res = {
            "y": cc.all_gather_raw(y.detach(), mesh, ctx.batch_axes, 0),
            "dx": cc.all_gather_raw(x_loc.grad, mesh, ctx.batch_axes, 0),
            "grads": gather_tree({"mlp": grads}, specs, mesh)["mlp"],
            "local": {k: tuple(t.shape) for k, t in p.items()},
        }
        out.append(res if mesh.rank == 0 else {"local": res["local"]})
    return out


def ring_cases(mesh, xs: np.ndarray, steps: int, axes) -> dict:
    """``compressed_psum`` of rank i's ``xs[i]`` over ``axes``: without error
    feedback once, and with it over ``steps`` steps (each step's result)."""
    i = mesh.index(axes)
    x = torch.from_numpy(np.array(xs[i]))
    plain, first_err = compressed_psum(x, mesh, axes)
    err, fed = torch.zeros_like(x), []
    for _ in range(steps):
        red, err = compressed_psum(x, mesh, axes, error=err)
        fed.append(red)
    return {"plain": plain, "first_err": first_err, "fed": torch.stack(fed), "last_err": err}


def prefill_and_decode_one(mesh, arch: str, plan: dict, tree: dict, B: int, S: int):
    """The mesh prefill step's logits of this rank's rows, and the mesh serve
    step's logits of ``S`` teacher-forced decode steps of the same tokens
    from an empty cache of ``S`` positions."""
    from repro_torch.configs import InputShape
    from repro_torch.models import transformer
    from repro_torch.training.train_step import make_serve_step

    cfg = get_config(arch).reduced()
    step = make_prefill_step(cfg, None, SchedulePlan(**plan), mesh=mesh)
    params = shard_params(convert.params_from_numpy(tree, cfg, device="cpu"), step.par)
    batch = batch_for(cfg, B, S)
    serve = make_serve_step(cfg, InputShape("decode", S, B, "decode"), SchedulePlan(**plan), mesh=mesh)
    cache = transformer.init_cache(cfg, B, S, device="cpu", par=serve.par)
    decoded = [serve(params, cache, batch["inputs"][:, t:t + 1], t)[0] for t in range(S)]
    return step(params, batch), torch.stack(decoded, 1)


def decode_cases(mesh, cases: list, trees: dict) -> list:
    """Each decode case (``arch``, ``plan`` kwargs, ``kv_dtype``, ``B``, ``L``,
    the whole starting ``cache`` as numpy, and per step ``tokens`` ``(B,)``,
    ``cur`` (a scalar or ``(B,)``) and ``commit`` (``(B,)`` or None)) through
    the mesh serve step from the whole cache sharded onto the mesh: every
    step's logits, the local shapes of the shard and of ``init_cache``'s
    allocation, the KV layout, and (rank 0) the cache gathered whole after
    the last step."""
    from repro_torch.configs import InputShape
    from repro_torch.models import transformer
    from repro_torch.training.train_step import make_serve_step

    out = []
    for case in cases:
        cfg = get_config(case["arch"]).reduced()
        if case.get("dtype"):  # the model's dtype (the reduced configs are f32)
            cfg = dataclasses.replace(cfg, dtype=case["dtype"])
        plan = SchedulePlan(**case["plan"], kv_dtype=case["kv_dtype"])
        B, L = case["B"], case["L"]
        step = make_serve_step(cfg, InputShape("decode", L, B, "decode"), plan, mesh=mesh)
        par = step.par
        params = shard_params(convert.params_from_numpy(trees[case.get("tree", case["arch"])], cfg,
                                                        device="cpu"), par)
        alloc = transformer.init_cache(cfg, B, L, case["kv_dtype"], device="cpu", par=par)
        # the whole cache, drawn in f32, in the dtypes the model's cache holds
        whole = {b: {k: torch.from_numpy(np.array(v)).to(alloc[b][k].dtype) for k, v in c.items()}
                 for b, c in case["cache"].items()}
        cache = transformer.shard_cache(whole, par)
        logits = []
        for tok, cur, commit in zip(case["tokens"], case["cur"], case["commit"]):
            lg, cache = step(params, cache, torch.from_numpy(np.array(tok))[:, None],
                             torch.as_tensor(np.array(cur)),
                             None if commit is None else torch.from_numpy(np.array(commit)))
            logits.append(lg)
        shapes = lambda tree: {f"{b}.{k}": tuple(v.shape) for b, c in tree.items() for k, v in c.items()}
        res = {"logits": torch.stack(logits), "local": shapes(cache), "alloc": shapes(alloc),
               "kv": tuple(par.kv), "rows_split": par.rows_split}
        gathered = gather_tree(cache, transformer.cache_specs(cfg, B, L, par, case["kv_dtype"]), mesh)
        if mesh.rank == 0:
            res["cache"] = gathered
        out.append(res)
    return out


# ---------------------------------------------------------------------------
# The dry run against a real step (tests/test_torch_dryrun.py)
# ---------------------------------------------------------------------------
def combine_case(mesh, q, k, v, k_s, v_s, cur, axes) -> tuple:
    """A cache of ``L`` positions (numpy ``(B, Hk, L, hd)``; ``k_s``/``v_s``
    the scales of an int8 one, or None) split by position over ``axes``:
    this rank attends over its shard with the plain version, and the shards
    combine twice, from each rank's ``lse`` (``softmax_combine``) and by the
    rule that combined from the masked logits themselves: both results."""
    from repro_torch.kernels import decode_attention as da

    n, r = mesh.size(axes), mesh.index(axes)
    Lr, hd = k.shape[2] // n, q.shape[-1]
    mine = slice(r * Lr, (r + 1) * Lr)
    t = lambda x: None if x is None else torch.from_numpy(np.ascontiguousarray(x[:, :, mine]))  # noqa: E731
    q_, cur_ = torch.from_numpy(q), torch.from_numpy(cur)
    k_, v_, ks_, vs_ = t(k), t(v), t(k_s), t(v_s)
    att, lse = da.decode_attention_plain(q_, k_, v_, ks_, vs_, cur_, r * Lr, hd ** -0.5)
    new = cc.softmax_combine(att, lse, mesh, axes)
    # the masked logits as the plain version forms them, (B, Hq, Lr)
    B, Hq, Hk = q.shape[0], q.shape[1], k.shape[1]
    kf = k_.float() if ks_ is None else k_.to(torch.bfloat16).float() * ks_
    logits = torch.einsum("bkgd,bktd->bkgt", q_.float().reshape(B, Hk, Hq // Hk, hd), kf)
    logits = (logits * hd ** -0.5).reshape(B, Hq, Lr)
    pos = torch.arange(r * Lr, (r + 1) * Lr)
    logits = logits.masked_fill(~(pos <= cur_[:, None, None]), -1e30)
    m = cc.all_reduce_(logits.amax(dim=-1, keepdim=True).contiguous(), mesh, axes, "max")
    w = torch.exp(logits - m).sum(dim=-1, keepdim=True)
    packed = cc.all_reduce_(torch.cat([(att * w).flatten(), w.flatten()]), mesh, axes)
    old = packed[:att.numel()].view(att.shape) / packed[att.numel():].view(w.shape)
    return new.numpy(), old.numpy(), lse.numpy()


@contextlib.contextmanager
def plain_kernels_counted():
    """Each kernel wrapper replaced by its plain version that counts launches
    as the CUDA branch does: one a forward call, and where autograd records
    (grad on and an input that requires grad) one a backward (the grouped
    GEMM's backward: one for each operand whose gradient is needed), by a
    hook on the output.  CPU only: the card runs the kernels."""
    from repro_torch.kernels import decode_attention as da, flash_attention as fa, moe_gemm as mg
    from repro_torch.kernels import quantize as qt, rmsnorm as rn, selective_scan as ss

    def recorded(*ts):
        return torch.is_grad_enabled() and any(t.requires_grad for t in ts)

    def backward_counts(out, counter, n=1):
        out.register_hook(lambda g: [counter.add() for _ in range(n)] and None)

    def rmsnorm(x, w, *, eps=1e-6):
        y = rn.rmsnorm_plain(x, w, eps=eps)
        rn.LAUNCHES.add()
        if recorded(x, w):
            backward_counts(y, rn.BWD_LAUNCHES)
        return y

    def flash_attention(q, k, v, *, causal=True, block_q=128, block_kv=128):
        o = fa.attention_plain(q, k, v, causal=causal)
        fa.LAUNCHES.add()
        if recorded(q, k, v):
            backward_counts(o, fa.BWD_LAUNCHES)
        return o

    def moe_gemm(x, w, *, block_c=128, block_f=128, block_d=256, x_t=False, w_t=False):
        y = mg.moe_gemm_plain(x, w, x_t=x_t, w_t=w_t)
        mg.LAUNCHES.add()
        if recorded(x, w):
            backward_counts(y, mg.LAUNCHES, int(x.requires_grad) + int(w.requires_grad))
        return y

    def selective_scan(u, dt, A, Bm, Cm, D, *, chunk=128, d_block=128):
        y = ss.selective_scan_plain(u, dt, A, Bm, Cm, D)
        ss.LAUNCHES.add()
        if recorded(u, dt, A, Bm, Cm, D):
            backward_counts(y, ss.BWD_LAUNCHES)
        return y

    def quantize_int8(x):
        qt.QUANT_LAUNCHES.add()
        return qt.quantize_int8_plain(x)

    def dequantize_int8(q, scale, dtype=torch.float32):
        qt.DEQUANT_LAUNCHES.add()
        return qt.dequantize_int8_plain(q, scale, dtype=dtype)

    def decode_attention(q, k, v, k_s, v_s, cur, o, scale):
        da.LAUNCHES.add()
        return da.decode_attention_plain(q, k, v, k_s, v_s, cur, o, scale)

    fakes = [(rn, "rmsnorm", rmsnorm), (fa, "flash_attention", flash_attention),
             (da, "decode_attention", decode_attention),
             (mg, "moe_gemm", moe_gemm), (ss, "selective_scan", selective_scan),
             (qt, "quantize_int8", quantize_int8), (qt, "dequantize_int8", dequantize_int8)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in fakes]
    for mod, name, fake in fakes:
        setattr(mod, name, fake)
    try:
        yield
    finally:
        for mod, name, orig in saved:
            setattr(mod, name, orig)


def real_counts(mesh, case: dict) -> dict:
    """One real CPU step of ``case`` (``arch`` reduced, ``kind``, ``plan``
    kwargs, ``B``, ``S``) on ``mesh`` (None: one device), from seed-0
    weights: its ``FlopCounterMode`` count, launches by kernel (the CUDA
    branch's, ``plain_kernels_counted``) and collectives by kind."""
    from torch.utils.flop_counter import FlopCounterMode

    cfg = get_config(case["arch"]).reduced()
    plan = SchedulePlan(**case["plan"])
    kind, B, S = case["kind"], case["B"], case["S"]
    shape = InputShape(kind, S, B, kind)
    params = transformer.init_params(cfg, 0, device="cpu")
    batch = batch_for(cfg, B, S)
    if kind == "train":
        oc = optim.OptimizerConfig(peak_lr=0.0, moment_dtype=plan.opt_dtype)
        step = make_train_step(cfg, shape, plan, oc, mesh=mesh, device="cpu")
        params = shard_params(params, step.par) if mesh is not None else params
        opt = optim.init_opt_state(params, oc, step.par)

        def run():
            step(params, opt, batch)
    elif kind == "prefill":
        step = make_prefill_step(cfg, shape, plan, mesh=mesh, device="cpu")
        params = shard_params(params, step.par) if mesh is not None else params

        def run():
            step(params, {k: batch[k] for k in ("inputs", "positions")})
    else:
        step = make_serve_step(cfg, shape, plan, mesh=mesh, device="cpu")
        params = shard_params(params, step.par) if mesh is not None else params
        cache = transformer.init_cache(cfg, B, S, plan.kv_dtype, device="cpu",
                                       par=step.par if mesh is not None else None)

        def run():
            step(params, cache, batch["inputs"][:, :1], S - 1)
    ops.reset_counters()
    cc.reset_counters()
    flops = FlopCounterMode(display=False)
    with plain_kernels_counted(), flops:
        run()
    return {"flops": flops.get_total_flops(), "launches": ops.launch_counts(),
            "coll": cc.counters()}


def real_counts_cases(mesh, cases: list) -> list:
    return [real_counts(mesh, case) for case in cases]


def whole_leaf_apply_updates(params, grads, state, oc, dist=None):
    """``optimizer.apply_updates`` as it was before it took leaves in chunks:
    each leaf's sum of squares and its whole update at once (the reference
    the chunked update is held to)."""
    dist = dist or ParallelContext.local(params)
    flat_p = list(optim.leaves(params))
    device = flat_p[0][1].device
    step = state["step"] + 1
    step_t = torch.tensor(step, dtype=torch.int32, device=device)
    lr = optim.lr_at(oc, step_t)
    gnorm = whole_leaf_global_norm(grads, dist)
    scale = torch.minimum(torch.ones((), device=device), oc.clip_norm / (gnorm + 1e-9))
    bc1 = 1.0 - oc.b1 ** step_t.to(torch.float32)
    bc2 = 1.0 - oc.b2 ** step_t.to(torch.float32)
    flat_g = dict(optim.leaves(grads))
    flat_mu, flat_nu = dict(optim.leaves(state["mu"])), dict(optim.leaves(state["nu"]))
    with torch.no_grad():
        for path, p in flat_p:
            g = flat_g[path].float() * scale
            m = oc.b1 * optim._mom_read(flat_mu[path]) + (1 - oc.b1) * g
            v = oc.b2 * optim._mom_read(flat_nu[path]) + (1 - oc.b2) * g * g
            delta = (m / bc1) / (torch.sqrt(v / bc2) + oc.eps)
            if p.ndim >= 2:
                delta = delta + oc.weight_decay * p.float()
            p.copy_((p.float() - lr * delta).to(p.dtype))
            optim._mom_write_(flat_mu[path], m, dist.mesh, dist.row_axes(path))
            optim._mom_write_(flat_nu[path], v, dist.mesh, dist.row_axes(path))
    state["step"] = step
    return params, state, {"lr": lr, "grad_norm": gnorm}


def whole_leaf_global_norm(tree, dist=None):
    """The global norm from each leaf's whole f32 sum of squares."""
    dist = dist or ParallelContext.local(tree)
    return torch.sqrt(dist.norm_sq({path: torch.sum(torch.square(g.float()))
                                    for path, g in optim.leaves(tree)}))


def chunked_update_case(mesh, tree: dict, specs: dict, chunk_elems: int, oc_kw: dict,
                        steps: int = 2, seed: int = 0) -> dict:
    """``steps`` updates of ``tree`` (whole numpy leaves, sharded by ``specs``,
    a tree of tuples of mesh axes, over ``mesh``; None: one device) by ``apply_updates`` with leaves in
    chunks of ``chunk_elems`` and by ``whole_leaf_apply_updates``, from the
    same numpy-drawn gradients: the paths of the parameters and moments
    that differ, the metrics of both, and each leaf's number of chunks."""
    optim.CHUNK_ELEMS = chunk_elems
    oc = optim.OptimizerConfig(**oc_kw)
    dist = None
    if mesh is not None:
        specs = optim.tree_from_leaves(specs, {k: PartitionSpec(*s) for k, s in _spec_leaves(specs)})
        shapes = {path: tuple(a.shape) for path, a in optim.leaves(tree)}
        dist = ParallelContext(mesh, specs, optim.tree_from_leaves(tree, shapes))

    def local(t):
        if mesh is not None:
            return shard_tree(t, specs, mesh)
        return {k: local(v) if isinstance(v, dict) else torch.from_numpy(v.copy()) for k, v in t.items()}

    runs = {}
    for name, update in (("chunked", optim.apply_updates), ("whole", whole_leaf_apply_updates)):
        rng = np.random.default_rng(seed)
        params = local(tree)
        state = optim.init_opt_state(params, oc, dist)
        metrics = []
        for _ in range(steps):
            grads = {k: (rng.standard_normal(a.shape) * 0.3).astype(a.dtype)
                     for k, a in optim.leaves(tree)}
            grads = local(optim.tree_from_leaves(tree, grads))
            params, state, m = update(params, grads, state, oc, dist)
            metrics.append({k: float(v) for k, v in m.items()})
        runs[name] = (params, state, metrics)
    (p_c, s_c, m_c), (p_w, s_w, m_w) = runs["chunked"], runs["whole"]
    differ = [path for (path, a), (_, b) in zip(optim.leaves(p_c), optim.leaves(p_w))
              if not torch.equal(a, b)]
    for mom in ("mu", "nu"):
        for (path, a), (_, b) in zip(optim.leaves(s_c[mom]), optim.leaves(s_w[mom])):
            pairs = [(a[k], b[k]) for k in ("q", "s")] if isinstance(a, dict) else [(a, b)]
            if not all(torch.equal(x, y) for x, y in pairs):
                differ.append(f"{mom}.{path}")
    return {"differ": differ, "metrics": {"chunked": m_c, "whole": m_w},
            "chunks": {path: len(optim.chunks(p.shape)) for path, p in optim.leaves(p_c)},
            "int8": sorted(path for path, m in optim.leaves(s_c["mu"]) if isinstance(m, dict))}


def _spec_leaves(specs: dict, prefix: str = ""):
    for k, v in specs.items():
        if isinstance(v, dict):
            yield from _spec_leaves(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def chunked_update_cases(mesh, cases: list) -> list:
    """``chunked_update_case`` of each case (its keyword arguments)."""
    return [chunked_update_case(mesh, **case) for case in cases]
