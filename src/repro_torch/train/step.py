"""Train state and train step (remat, grad accumulation, compression):
the port of ``repro.train.step``.

A train state is ``{"params": Model, "opt": ..., "step": int32 tensor}``:
the parameters are the model's own modules and the optimizer state keeps
the reference's stacked layout (``optim.optimizers``).  Gradients come
from autograd as a list in ``params.flat_params`` order.  The step
updates the model and the optimizer state in place and returns the
state with the step advanced, as the reference's jitted step (which
donates its state) returns the new one.

On a ``DeviceMesh`` (the dry run's): ``shard_state`` turns a state's
tensors into DTensors placed by the reference's sharding rules, and the
same step then runs sharded: each parameter is gathered over the
data-parallel axes before the forward (``gather_params``: FSDP, whose
backward reduce-scatters the gradient), the model axis stays sharded
(tensor, expert and vocabulary parallel), and tensors made inside the
model count as replicated.  Without DTensors nothing of this runs.
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.models import causal_lm_loss, transformer
from repro_torch.models.lm import Model
from repro_torch.models.params import flat_params, stacked_leaves
from repro_torch.optim import optimizers as opt_lib
from repro_torch.sharding import rules as rules_lib

METRICS = ("nll", "aux", "loss")


def init_state(model, tcfg):
    """The state of ``model`` (initialised already, from its seed)."""
    return {"params": model,
            "opt": opt_lib.opt_init(tcfg.optimizer)(model),
            "step": torch.zeros((), dtype=torch.int32,
                                device=next(model.parameters()).device)}


def abstract_state(model, tcfg):
    """The state in the reference's stacked layout as tensors on the
    ``meta`` device (nothing allocated): what ``CheckpointManager.restore``
    reads into."""
    meta = Model(model.cfg, device="meta")
    return {"params": meta.abstract(),
            "opt": opt_lib.opt_init(tcfg.optimizer)(meta),
            "step": torch.empty((), dtype=torch.int32, device="meta")}


def state_shardings(model, tcfg, mesh):
    """DeviceMesh placements of every leaf of the stacked state, as the
    reference's ``NamedSharding``s: parameters by ``rules.param_shardings``,
    AdamW's state like its parameter, Adafactor's factored statistics with
    the reduced dim's entry dropped, the counters replicated."""
    return _state_placements(model, tcfg.optimizer, mesh)


def _state_placements(model, optimizer, mesh):
    Spec = rules_lib.Spec
    specs = rules_lib.param_shardings(model.spec, mesh)
    repl = rules_lib.replicated(mesh)

    def fact(spec):
        if len(spec) >= 2:
            return (Spec(spec[:-1]), Spec(spec[:-2] + spec[-1:]))
        return (spec, Spec())

    if optimizer == "adamw":
        opt = {"m": specs, "v": specs, "count": repl}
    else:
        opt = {"v": _map_specs(fact, specs), "m": specs, "count": repl}
    return _map_specs(lambda s: rules_lib.placements(s, mesh),
                      {"params": specs, "opt": opt, "step": repl})


def _map_specs(fn, tree):
    """Map ``fn`` over the ``Spec`` leaves of a tree of dicts and tuples."""
    if isinstance(tree, rules_lib.Spec):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    return tuple(_map_specs(fn, v) for v in tree)


# ------------------------------------------------------------ on a mesh

def _place(t, placements, mesh):
    """``t`` as a DTensor with ``placements``; a mesh dim of one rank
    holds it whole (``Replicate``), as a sharding over one device is."""
    placements = [Replicate() if mesh.size(i) == 1 else p
                  for i, p in enumerate(placements)]
    return distribute_tensor(t.detach(), mesh, placements)


def _place_tree(tree, pl, mesh):
    """The tensors of ``tree`` placed by the same-shaped tree ``pl`` of
    placements or ``Spec``s."""
    if isinstance(tree, torch.Tensor):
        if isinstance(pl, rules_lib.Spec):
            pl = rules_lib.placements(pl, mesh)
        return _place(tree, pl, mesh)
    if isinstance(tree, dict):
        return {k: _place_tree(v, pl[k], mesh) for k, v in tree.items()}
    return type(tree)(_place_tree(v, p, mesh) for v, p in zip(tree, pl))


def _optimizer_of(opt) -> str:
    node = opt["v"]
    while isinstance(node, dict):
        node = next(iter(node.values()))
    return "adafactor" if isinstance(node, tuple) else "adamw"


def shard_state(state, mesh):
    """``state``'s tensors as DTensors on ``mesh``, placed as the
    reference's dry run shards them: the parameters of ``"params"`` (a
    ``Model``, whose parameters are replaced in place) by
    ``rules.param_specs``, ``"opt"`` and ``"step"`` by ``state_shardings``,
    ``"cache"`` by ``rules.cache_shardings`` and ``"batch"`` by
    ``rules.batch_shardings_for``.  Returns a new dict of the same keys.
    A tensor on the ``meta`` device stays there (a shard of shapes only)."""
    out = dict(state)
    model = state["params"]
    specs = rules_lib.param_specs(model, mesh)
    for name, p in list(model.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        setattr(model.get_submodule(owner), leaf, nn.Parameter(
            _place(p, rules_lib.placements(specs[name], mesh), mesh),
            requires_grad=p.requires_grad))
    if "opt" in state:
        pl = _state_placements(model, _optimizer_of(state["opt"]), mesh)
        out["opt"] = _place_tree(state["opt"], pl["opt"], mesh)
        out["step"] = _place_tree(state["step"], pl["step"], mesh)
    if "cache" in state:
        out["cache"] = _place_tree(
            state["cache"], rules_lib.cache_shardings(state["cache"], mesh),
            mesh)
    if "batch" in state:
        out["batch"] = _place_tree(
            state["batch"],
            rules_lib.batch_shardings_for(state["batch"], mesh), mesh)
    return out


def mesh_of(model):
    """The ``DeviceMesh`` of ``model``'s DTensor parameters, else None."""
    p = next(model.parameters())
    return p.device_mesh if isinstance(p, DTensor) else None


def gather_params(model, leaves: bool = False):
    """``model``'s parameters as a sharded forward reads them: (a tree of
    dicts, lists under ``"layers"``, and the same tensors in
    ``flat_params`` order).  Each is its DTensor parameter gathered over
    the mesh's data-parallel axes (one all-gather each, whose backward
    reduce-scatters the gradient), the model axis left as placed.  With
    ``leaves`` the gathered tensors are new autograd leaves instead, for
    a caller that reduces their gradients itself (``gather_once``)."""
    mesh = mesh_of(model)
    dp = set(rules_lib.dp_axes(mesh))
    names = mesh.mesh_dim_names
    got = {}

    def gathered(p):
        pl = tuple(Replicate() if names[i] in dp else x
                   for i, x in enumerate(p.placements))
        g = p if pl == tuple(p.placements) else p.redistribute(mesh, pl)
        if leaves:
            g = g.detach().requires_grad_(p.requires_grad)
        got[id(p)] = g
        return g

    def walk(node):
        if isinstance(node, nn.ModuleList):
            return [walk(m) for m in node]
        out = {k: walk(m) for k, m in node._modules.items()}
        out.update((k, gathered(p)) for k, p in node._parameters.items())
        return out
    tree = walk(model)
    return tree, [got[id(p)] for p in flat_params(model)]


def sharded(model):
    """The context a step or forward of ``model`` runs in: DTensor's
    implicit replication of plain tensors on a mesh, else nothing."""
    return implicit_replication() if mesh_of(model) is not None \
        else contextlib.nullcontext()


def _replicated(x):
    """A DTensor made replicated (a pending sum all-reduced)."""
    if isinstance(x, DTensor):
        return x.redistribute(x.device_mesh,
                              [Replicate()] * x.device_mesh.ndim)
    return x


# ---------------------------------------------------------------- the step

def _loss_fn(model, tcfg, batch, tree=None):
    """The loss of ``batch``; on a mesh through ``tree`` (the gathered
    parameters, gathered here when not given)."""
    cfg = model.cfg
    kw = {k: batch[k] for k in ("enc_embeds", "prefix_embeds") if k in batch}
    if mesh_of(model) is None:
        logits, _, aux = model(batch["tokens"], mode="train", **kw)
    else:
        if tree is None:
            tree, _ = gather_params(model)
        logits, _, aux = transformer.forward(
            tree, cfg, batch["tokens"], mode="train", **kw)
    loss, metrics = causal_lm_loss(logits, batch["targets"], cfg,
                                   batch.get("mask"), z_loss=tcfg.z_loss)
    total = _replicated(loss + 0.01 * aux)
    metrics = {k: _replicated(v)
               for k, v in dict(metrics, aux=aux, loss=loss).items()}
    return total, metrics


def _grad(total, params):
    """d total / d params; zeros for a parameter the loss does not reach,
    as the reference's gradient tree has."""
    return list(torch.autograd.grad(total, params, allow_unused=True,
                                    materialize_grads=True))


def _detached(metrics):
    return {k: metrics[k].detach().float() for k in METRICS}


def _micro(batch, i, nm):
    """Microbatch ``i`` of ``nm``: rows ``[i*b/nm, (i+1)*b/nm)`` of the
    batch; on a mesh those rows of each rank's shard (each data-parallel
    rank splits its own rows, so no microbatch gathers the batch)."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, DTensor):
            loc = v.to_local()
            if loc.shape[0] % nm:
                raise ValueError(f"a rank's {loc.shape[0]} rows do not "
                                 f"split into {nm} microbatches")
            step = loc.shape[0] // nm
            out[k] = DTensor.from_local(loc[i * step:(i + 1) * step],
                                        v.device_mesh, v.placements,
                                        run_check=False)
        else:
            step = v.shape[0] // nm
            out[k] = v[i * step:(i + 1) * step]
    return out


def grads_of(model, tcfg, batch):
    """(gradients in ``flat_params`` order, metrics) of ``batch``.

    ``tcfg.microbatch > 1`` accumulates the gradients of that many equal
    batch slices in float32 and divides by their number, and averages the
    metrics (activation memory / microbatch, same math).  On a mesh with
    ``tcfg.gather_once`` the parameters are gathered once for all
    microbatches and the accumulated gradients reduce-scattered once."""
    params = flat_params(model)
    once = tcfg.gather_once and mesh_of(model) is not None
    tree, wrt = gather_params(model, leaves=True) if once else (None, params)
    nm = tcfg.microbatch
    if not (nm and nm > 1):
        total, metrics = _loss_fn(model, tcfg, batch, tree)
        return _scatter(_grad(total, wrt), params, once), _detached(metrics)
    b = batch["tokens"].shape[0]
    if b % nm:
        raise ValueError(f"batch {b} does not split into {nm} microbatches")
    # with gather_once the first microbatch's gradients start the sum, so
    # that it stays a pending sum over the data-parallel ranks
    g_acc = None if once else [torch.zeros_like(p, dtype=torch.float32)
                               for p in params]
    m_acc = None
    for i in range(nm):
        total, metrics = _loss_fn(model, tcfg, _micro(batch, i, nm), tree)
        g = [x.float() for x in _grad(total, wrt)]
        if g_acc is None:
            g_acc = g
        else:
            torch._foreach_add_(g_acc, g)
        m = _detached(metrics)
        m_acc = m if m_acc is None else {k: m_acc[k] + m[k] for k in m}
    torch._foreach_div_(g_acc, nm)
    return _scatter(g_acc, params, once), {k: v / nm for k, v in m_acc.items()}


def _scatter(grads, params, once):
    """With ``gather_once``, each gradient placed like its parameter (the
    step's one reduce-scatter); else ``grads`` as they are."""
    if not once:
        return grads
    return [g.redistribute(p.device_mesh, p.placements)
            for g, p in zip(grads, params)]


def build_train_step(model, tcfg):
    """Returns train_step(state, batch) -> (state, metrics).

    * microbatch > 1: gradient accumulation over batch slices (``grads_of``).
    * on a mesh (``shard_state``) the step runs on DTensors; each
      microbatch's forward gathers the parameters over the data-parallel
      axes (``gather_params``), or the step gathers them once with
      ``gather_once`` (``grads_of``).  Without a mesh the step gathers
      nothing, as the reference's does not.
    The metrics are ``nll``, ``aux``, ``loss``, ``grad_norm`` and ``lr``
    (float32 tensors on the device)."""
    update_fn = opt_lib.opt_update(tcfg.optimizer)

    def train_step(state, batch):
        params = state["params"]
        with sharded(params):
            return _step(state, params, batch)

    def _step(state, params, batch):
        grads, metrics = grads_of(params, tcfg, batch)
        grads, gnorm = opt_lib.clip_by_global_norm(grads, tcfg.grad_clip)
        lr = opt_lib.warmup_cosine(state["step"], peak=tcfg.learning_rate,
                                   warmup=tcfg.warmup_steps,
                                   total=tcfg.total_steps)
        _, new_opt = update_fn(grads, state["opt"], params, lr=lr, b1=tcfg.b1,
                               weight_decay=tcfg.weight_decay)
        metrics = dict(metrics, grad_norm=gnorm, lr=lr)
        return ({"params": params, "opt": new_opt,
                 "step": state["step"] + 1}, metrics)

    return train_step


# ------------------------------------------------- int8 DP grad compression

def quantize_int8(g):
    scale = torch.clamp(torch.max(torch.abs(g)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def compressed_psum(g, group=None):
    """int8-quantised all-reduce with a *shared* scale over ``group``: the
    max-abs all-reduced with MAX (one scalar collective), quantise
    everywhere with the same step, sum as int32, rescale and divide by
    the group's size (the mean).  ~3.5x wire reduction on the DP axis
    (int8+scalar vs f32) at <1% relative error on the averaged
    gradient."""
    g = g.float()
    gmax = torch.max(torch.abs(g))
    dist.all_reduce(gmax, op=dist.ReduceOp.MAX, group=group)
    scale = torch.clamp(gmax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    qsum = q.to(torch.int32)
    dist.all_reduce(qsum, group=group)
    return (qsum.float() * scale) / dist.get_world_size(group)


def build_compressed_grads(model, tcfg, group=None):
    """Data-parallel gradients with the int8 compressed all-reduce over the
    process group ``group`` (default: the world).

    Returns grads_fn(params, batch) -> (grads, metrics): every rank passes
    the same global batch and takes its own equal slice of rows, as the
    reference's ``shard_map`` over the DP axes does; the gradients (in
    ``flat_params`` order) and the metrics are averaged over the ranks.
    Each leaf of the stacked spec shares one scale over its repetitions,
    as the reference's stacked leaf does."""
    rank, n = dist.get_rank(group), dist.get_world_size(group)

    def grads_fn(params, batch):
        b = batch["tokens"].shape[0]
        if b % n:
            raise ValueError(f"batch {b} does not split over {n} ranks")
        lo, hi = rank * b // n, (rank + 1) * b // n
        local = {k: v[lo:hi] for k, v in batch.items()}
        total, metrics = _loss_fn(params, tcfg, local)
        g = _grad(total, flat_params(params))
        out, i = [], 0
        for path, _, ts in stacked_leaves(params):
            gs, i = g[i:i + len(ts)], i + len(ts)
            if "layers" in path:
                out.extend(compressed_psum(torch.stack(gs), group).unbind(0))
            else:
                out.append(compressed_psum(gs[0], group))
        metrics = _detached(metrics)
        for v in metrics.values():
            dist.all_reduce(v, group=group)
        return out, {k: v / n for k, v in metrics.items()}

    return grads_fn
