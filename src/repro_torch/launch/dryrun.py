"""Dry run of the (arch x shape) cells on the production mesh (the port of
``repro.launch.dryrun``).

    python -m repro_torch.launch.dryrun --arch all --shape all --both-meshes
    python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k \\
        --device cpu

The reference jits each cell's train step (or prefill / decode forward)
with its rules' shardings on 512 forced host devices and compiles it.
The port runs the cell's program itself, sharded: on a ``DeviceMesh`` of a
fake process group of 512 ranks (``launch.mesh``), on tensors of the
``meta`` device (shapes and dtypes, no data, nothing allocated), placed as
DTensors by the same rules (``train.step.shard_state``).  What rank 0
does is measured as it runs (``Meter``): the FLOPs of its local ops by
``FlopCounterMode``'s formulas, the bytes its ops read and write, the
bytes alive at the peak, and the collectives DTensor issues
(``utils.collectives``).  Each cell writes one JSON file under
``artifacts/dryrun_torch/``:

  status, arch, shape, mesh, n_devices, n_params, device, trace_sec,
  flops_per_device, op_bytes_per_device, collectives_scaled,
  collective_ops, memory {argument_bytes, output_bytes, temp_bytes,
  peak_bytes}, fits, wall_sec

``op_bytes_per_device`` counts every op's inputs and outputs, unfused (XLA's
``bytes accessed`` is after fusion); ``fits`` says whether the peak fits
the card's memory (null when the mesh is not on a card).  FakeTensorMode
is not used: DTensor's sharding propagation calls ``tolist`` on index
tensors the mode would fake (``_StridedShard``); the meta device has no
such mode.  Only the dry run calls ``launch.mesh``'s fake group, in its
own process.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
import weakref

import torch
from torch.distributed.tensor import DTensor
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import (ARCH_IDS, SHAPES, TrainConfig, applicable,
                                 get_config, input_specs)
from repro_torch.core.backend import resolve_device
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.models import Model, transformer
from repro_torch.train import step as step_lib
from repro_torch.utils import collectives

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__),
                            "..", "..", "..", "artifacts", "dryrun_torch")

# the CUDA caching allocator hands out blocks of multiples of this many
# bytes (``torch.cuda.memory_allocated`` counts the blocks)
BLOCK = 512


def dryrun_config(arch: str, constrain: bool = False):
    """bf16 compute for the roofline target (the reference's choice)."""
    cfg = get_config(arch).replace(dtype="bfloat16", param_dtype="bfloat16")
    if constrain:
        cfg = cfg.replace(constrain_acts=True)
    return cfg


def n_params(cfg) -> int:
    return Model(cfg, device="meta").n_params()


def tcfg_for(cfg):
    """(TrainConfig, remat) by the reference's size thresholds."""
    n = n_params(cfg)
    opt = "adafactor" if n > 100e9 else "adamw"
    micro = 8 if n > 100e9 else (4 if n > 8e9 else 0)
    remat = cfg.remat if cfg.remat != "none" else \
        ("dots" if n > 2e9 else "none")
    return TrainConfig(optimizer=opt, microbatch=micro), remat


def _front_kw(cfg, specs):
    return {k: specs[k] for k in ("enc_embeds", "prefix_embeds")
            if k in specs}


def _local(t):
    return t.to_local() if isinstance(t, DTensor) else t


def tensors(tree) -> list:
    """The tensors of a tree of dicts, lists and tuples, a module's
    parameters among them, as rank 0 holds them (a DTensor's shard)."""
    out = []
    for x in tree_leaves(tree):
        if isinstance(x, torch.nn.Module):
            out.extend(_local(p) for p in x.parameters())
        elif isinstance(x, torch.Tensor):
            out.append(_local(x))
    return out


def local_bytes(tree) -> int:
    """Bytes of the tensors of ``tree`` on one rank."""
    return sum(collectives.tensor_bytes(t) for t in tensors(tree))


def allocator_bytes(tree) -> int:
    """What ``torch.cuda.memory_allocated`` counts for the tensors of
    ``tree`` on one rank: each storage in blocks of ``BLOCK`` bytes."""
    seen = {id(st): -(-st.nbytes() // BLOCK) * BLOCK
            for st in (t.untyped_storage() for t in tensors(tree))}
    return sum(seen.values())


class Meter(collectives.Recorder):
    """Rank 0's ops as they run, below DTensor: FLOPs (``FlopCounterMode``'s
    formulas, with its decompositions), the bytes every non-view op reads
    and writes, the bytes of live storages and their peak, and the
    collectives (``collectives.Recorder``).  ``track`` registers the
    tensors alive before the run (its arguments)."""

    def __init__(self):
        super().__init__()
        self._registry = FlopCounterMode(display=False).flop_registry
        self.flops = 0
        self.op_bytes = 0
        self.live = 0
        self.peak = 0
        self._storages = {}
        self._composite = {}

    def track(self, tree):
        for t in tensors(tree):
            self._add(t)
        self.peak = max(self.peak, self.live)

    def _add(self, t):
        st = t.untyped_storage()
        key = id(st)
        if key in self._storages:
            return
        n = st.nbytes()
        self._storages[key] = n
        self.live += n
        weakref.finalize(st, self._free, key)

    def _free(self, key):
        self.live -= self._storages.pop(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        skip = self._delegate(types)
        kwargs = kwargs or {}
        if skip is NotImplemented:
            return skip
        if skip:
            return func(*args, **kwargs)
        if func not in self._registry and self._decomposes(func):
            with self:
                r = func.decompose(*args, **kwargs)
                if r is not NotImplemented:
                    return r
        out = func(*args, **kwargs)
        self.observe(func, args, kwargs, out)
        return out

    def _decomposes(self, func) -> bool:
        """Whether ``func.decompose`` has a decomposition to run (the test
        it makes, cached per op)."""
        if func not in self._composite:
            key = torch._C.DispatchKey.CompositeImplicitAutograd
            self._composite[func] = \
                func is not torch.ops.prim.device.default and (
                    key in func.py_kernels
                    or torch._C._dispatch_has_kernel_for_dispatch_key(
                        func.name(), key))
        return self._composite[func]

    def observe(self, func, args, kwargs, out):
        super().observe(func, args, kwargs, out)
        packet = func._overloadpacket
        if packet in self._registry:
            self.flops += self._registry[packet](*args, **kwargs,
                                                 out_val=out)
        outs = collectives.flat_tensors(out)
        if not func.is_view:
            self.op_bytes += sum(
                collectives.tensor_bytes(t)
                for t in collectives.flat_tensors((args, kwargs)) + outs)
        for t in outs:
            self._add(t)
        self.peak = max(self.peak, self.live)


def _measure(fn, args):
    """Run ``fn(*args)`` under a ``Meter`` that tracks ``args``."""
    meter = Meter()
    meter.track(args)
    t0 = time.time()
    with meter:
        out = fn(*args)
    return out, meter, time.time() - t0


def _record(meter, args, out, trace_s, device):
    arg_bytes = local_bytes(args)
    coll = collectives.collective_bytes(meter.records)
    fits = None
    if device.type == "cuda":
        fits = meter.peak <= torch.cuda.get_device_properties(
            device).total_memory
    return {
        "trace_sec": round(trace_s, 1),
        "flops_per_device": float(meter.flops),
        "op_bytes_per_device": float(meter.op_bytes),
        "collectives_scaled": {k: float(v) for k, v in coll.items()},
        "collective_ops": {k: collectives.count_ops(meter.records, k)
                           for k in collectives.KINDS},
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": local_bytes(out),
            "temp_bytes": meter.peak - arg_bytes,
            "peak_bytes": meter.peak,
        },
        "fits": fits,
    }


def run_train(cfg, tcfg, specs, mesh, device):
    """One train step of ``cfg`` on the batch ``specs`` (meta tensors) on
    ``mesh``, measured: the cell's record without its names, and the
    state's bytes on one rank as the CUDA allocator counts them
    (``state_alloc_bytes``)."""
    model = Model(cfg, device="meta")
    state = step_lib.init_state(model, tcfg)
    state["batch"] = specs
    state = step_lib.shard_state(state, mesh)
    batch = state.pop("batch")
    fn = step_lib.build_train_step(model, tcfg)
    out, meter, trace_s = _measure(fn, (state, batch))
    rec = _record(meter, (state, batch), out, trace_s, device)
    rec["state_alloc_bytes"] = allocator_bytes(state)
    return rec


def run_serve(cfg, shape, specs, mesh, device):
    """One prefill or decode forward of ``cfg`` on ``mesh`` (the
    reference's cell functions), measured."""
    model = Model(cfg, device="meta")
    cache = model.init_cache(shape.global_batch, shape.seq_len)
    state = step_lib.shard_state(
        {"params": model, "cache": cache, "batch": specs}, mesh)

    def fn(model, cache, batch):
        with torch.no_grad(), step_lib.sharded(model):
            tree, _ = step_lib.gather_params(model)
            if shape.kind == "prefill":
                logits, cache, _ = transformer.forward(
                    tree, cfg, batch["tokens"], mode="prefill", cache=cache,
                    **_front_kw(cfg, batch))
            else:
                logits, cache, _ = transformer.forward(
                    tree, cfg, batch["tokens"], mode="decode", cache=cache,
                    pos=batch["pos"])
            return logits[:, -1 if shape.kind == "prefill" else 0], cache

    args = (model, state["cache"], state["batch"])
    out, meter, trace_s = _measure(fn, args)
    return _record(meter, args, out, trace_s, device)


def lower_cell(arch: str, shape_name: str, mesh, constrain: bool = False,
               gather_once: bool = False, remat_override: str = "",
               micro_override: int = -1, device=None):
    """One cell's record (the reference's ``lower_cell`` with the port's
    measurements)."""
    device = resolve_device(device)
    cfg = dryrun_config(arch, constrain)
    if remat_override:
        cfg = cfg.replace(remat=remat_override)
    shape = SHAPES[shape_name]
    ok, reason = applicable(cfg, shape)
    if not ok:
        return {"status": "skipped", "reason": reason}
    specs = input_specs(cfg, shape)
    if shape.kind == "train":
        tcfg, remat = tcfg_for(cfg)
        if remat_override:
            remat = remat_override
        if gather_once:
            tcfg = dataclasses.replace(tcfg, gather_once=True)
        if micro_override >= 0:
            tcfg = dataclasses.replace(tcfg, microbatch=micro_override)
        if remat != cfg.remat:
            cfg = cfg.replace(remat=remat)
        rec = run_train(cfg, tcfg, specs, mesh, device)
    else:
        rec = run_serve(cfg, shape, specs, mesh, device)
    return {"status": "ok", "arch": arch, "shape": shape_name,
            "mesh": "x".join(str(s) for s in mesh.mesh.shape),
            "n_devices": int(mesh.size()), "n_params": n_params(cfg),
            "device": device.type, **rec}


def predict_step(cfg, tcfg, batch: dict, device=None) -> dict:
    """One train step of ``cfg`` on ``batch`` (tensors on any device; only
    their shapes and dtypes are read) on one device (a 1x1 mesh), measured
    as a cell is: the state's bytes as the CUDA allocator counts them, the
    step's FLOPs and its peak bytes (state and batch included), to hold
    against a real step."""
    device = resolve_device(device)
    mesh = make_mesh((1, 1), ("data", "model"), device)
    specs = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
             for k, v in batch.items()}
    rec = run_train(cfg, tcfg, specs, mesh, device)
    return {"state_bytes": rec["state_alloc_bytes"],
            "flops": rec["flops_per_device"],
            "peak_bytes": rec["memory"]["peak_bytes"],
            "trace_sec": rec["trace_sec"]}


def _names(arg: str, known) -> list:
    return list(known) if arg == "all" else arg.split(",")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="all",
                    help="arch id, ids joined by commas, or 'all'")
    ap.add_argument("--shape", default="all",
                    help="shape name, names joined by commas, or 'all'")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--constrain", action="store_true",
                    help="activation sharding constraints (PERF variant)")
    ap.add_argument("--gather-once", action="store_true",
                    help="hoist FSDP param all-gather out of microbatching")
    ap.add_argument("--tp", type=int, default=0,
                    help="override model-axis size (mesh 256/tp x tp)")
    ap.add_argument("--remat", default="",
                    help="override remat policy (none|dots|full)")
    ap.add_argument("--microbatch", type=int, default=-1,
                    help="override microbatch count")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=ARTIFACT_DIR)
    ap.add_argument("--device", default=None,
                    help="the mesh's device type (default: the card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    archs = _names(args.arch, ARCH_IDS)
    shapes = _names(args.shape, SHAPES)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    os.makedirs(args.out, exist_ok=True)

    for multi_pod in meshes:
        if args.tp:
            mesh = make_mesh((256 // args.tp, args.tp), ("data", "model"),
                             device)
            mesh_name = f"{256 // args.tp}x{args.tp}"
        else:
            mesh = make_production_mesh(multi_pod=multi_pod, device=device)
            mesh_name = "2x16x16" if multi_pod else "16x16"
        for arch in archs:
            for shape_name in shapes:
                suffix = ""
                if args.constrain:
                    suffix += "__opt"
                if args.gather_once:
                    suffix += "__g1"
                if args.remat:
                    suffix += f"__r{args.remat}"
                if args.microbatch >= 0:
                    suffix += f"__m{args.microbatch}"
                tag = f"{arch}__{shape_name}__{mesh_name}" + suffix
                path = os.path.join(args.out, tag + ".json")
                t0 = time.time()
                try:
                    res = lower_cell(arch, shape_name, mesh,
                                     constrain=args.constrain,
                                     gather_once=args.gather_once,
                                     remat_override=args.remat,
                                     micro_override=args.microbatch,
                                     device=device)
                except Exception as e:            # noqa: BLE001
                    res = {"status": "error", "error": repr(e),
                           "traceback": traceback.format_exc()}
                res["wall_sec"] = round(time.time() - t0, 1)
                with open(path, "w") as f:
                    json.dump(res, f, indent=1)
                status = res["status"]
                extra = ""
                if status == "ok":
                    mem = res["memory"]
                    wire = res["collectives_scaled"]["wire_bytes"]
                    extra = (f" flops/dev={res['flops_per_device']:.3e}"
                             f" coll={wire:.3e}B"
                             f" mem[args={mem['argument_bytes']:.2e}"
                             f" temp={mem['temp_bytes']:.2e}"
                             f" out={mem['output_bytes']:.2e}]B"
                             f" fits={res['fits']}"
                             f" trace={res['trace_sec']}s")
                elif status == "error":
                    extra = " " + res["error"][:120]
                print(f"[dryrun] {tag}: {status}{extra}", flush=True)


if __name__ == "__main__":
    main()
