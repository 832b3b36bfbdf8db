"""Multi-pod dry-run: trace one train step, prefill or decode step of every
(architecture x input shape) cell at full width, as one rank of the
production meshes sees it, and extract memory / cost / collective
evidence against the H100 roofline.  The counterpart of
``repro.launch.dryrun``, which lowers and compiles on 512 placeholder
XLA devices.

How it works, in its own process and without touching a GPU:
  * a fake process group of 256 (``(16, 16)``) or 512 (``(2, 16, 16)``)
    ranks, this process rank 0, and the production ``DeviceMesh`` over it
    (its collectives complete at once and move nothing);
  * the task built on the ``meta`` device (shapes and dtypes, no
    memory), its parameters placed by ``parallel.sharding`` as DTensors,
    the batch cut by ``data_shardings``;
  * one step traced under ``roofline.hlo_cost.CostMode``: per-device
    FLOPs, bytes and collective wire bytes over this rank's aten ops on
    its local shards, and the peak of the live storages the step creates
    (the arguments counted apart, as XLA's memory analysis does);
  * the roofline of ``roofline.analysis`` on the ``H100_SXM`` model.

A decode cell's caches are this rank's batch rows, whole over ``model``
(the reference cuts their longest axis over it): the record lists it
under ``differences``.  ``lower_s`` is the time to build and place the
cell, ``compile_s`` the time to trace its step.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all             # single-pod sweep
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod
Results land in experiments/dryrun_torch/<mesh>/<arch>__<shape>.json
(``--out`` elsewhere).  ``--reduced`` and ``--mesh-shape D,M`` trace a
CPU-sized config on a small (data, model) mesh, for tests.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")


def _mesh_tag(multi_pod: bool, mesh_shape=None) -> str:
    if mesh_shape:
        return "mesh" + "x".join(str(n) for n in mesh_shape)
    return "pod2x16x16" if multi_pod else "pod16x16"


def fake_process_group(world: int) -> None:
    """This process as rank 0 of a fake process group of ``world`` ranks
    (``torch.testing._internal``'s fake backend: collectives complete at
    once and move nothing).  Raises if the backend is missing."""
    import torch.distributed as dist

    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(
            "the dry-run needs torch's fake process group "
            "(torch.testing._internal.distributed.fake_pg)") from e
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def make_mesh(multi_pod: bool, mesh_shape=None):
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.mesh import make_production_mesh

    if mesh_shape:
        return init_device_mesh("cpu", tuple(mesh_shape),
                                mesh_dim_names=("data", "model"))
    return make_production_mesh(multi_pod=multi_pod, device="cpu")


TRACE = "meta"      # the device the cells are traced on: shapes, no data


def _nbytes(tree) -> int:
    from repro_torch.roofline.hlo_cost import _nbytes, _tensors

    return sum(_nbytes(t) for t in _tensors(tree))


def _depths(cfg):
    """The two depths traced and the full depth, in repeats of the layer
    pattern: (cfg at one repeat, cfg at two, repeats of the full model)."""
    if cfg.encoder_decoder:
        if cfg.n_layers != cfg.n_encoder_layers:
            raise ValueError("the dry-run extrapolates encoder and decoder "
                             "together: their depths must match")

        def at(k):
            return dataclasses.replace(cfg, n_layers=k, n_encoder_layers=k)
        return at(1), at(2), float(cfg.n_layers)
    p = len(cfg.pattern)

    def at(k):
        return dataclasses.replace(cfg, n_layers=k * p)
    return at(1), at(2), cfg.n_layers / p


@dataclasses.dataclass
class _Placed:
    """One cell's task and step arguments on ``TRACE``, placed on the
    mesh as a rank holds them."""
    task: object
    model: object
    param_specs: dict
    batch: dict             # DTensors cut by data_shardings
    axes: tuple             # the mesh dims the batch is cut over
    opt_state: object = None
    caches: object = None

    def args(self):
        from repro_torch.train import loop as loop_lib

        return [loop_lib.named_params(self.model), self.batch,
                self.opt_state, self.caches]


def _place(cfg, shape_name: str, mesh, opt_name: str) -> _Placed:
    """Build the task on ``TRACE``, place its parameters by
    ``param_shardings``, cut the batch by ``data_shardings``, and add the
    optimizer state (a train cell) or this rank's caches (a decode
    cell: its batch rows, whole over ``model``)."""
    import torch

    from repro_torch.models import registry
    from repro_torch.models.encdec import EncDecLM
    from repro_torch.models.transformer import DecoderLM
    from repro_torch.parallel import sharding as shard_lib
    from repro_torch.parallel import util as par
    from repro_torch.train import loop as loop_lib
    from repro_torch.train import optimizer as opt_lib

    profile = cfg.sharding_profile
    cell = registry.SHAPES[shape_name]
    task = registry.make_task(cfg, TRACE)
    specs = task.input_specs(shape_name)
    model = (EncDecLM if cfg.encoder_decoder else DecoderLM)(cfg, TRACE)
    p_sh = shard_lib.param_shardings(model, mesh, profile)
    par.distribute_module(model, p_sh, mesh)
    batch = {k: v for k, v in specs["batch"].items() if k != "pos"}
    batch = loop_lib.shard_batch(
        batch, shard_lib.data_shardings(batch, mesh, profile), mesh)
    first = next(iter(batch.values()))
    axes = tuple(a for a, pl in zip(mesh.mesh_dim_names, first.placements)
                 if pl.is_shard())
    placed = _Placed(task, model, p_sh, batch, axes)
    if cell.kind == "train":
        state = opt_lib.init(loop_lib.named_params(model),
                             opt_lib.OptConfig(name=opt_name))
        placed.opt_state = par.distribute_tree(state, shard_lib.opt_shardings(
            state, p_sh, mesh, profile), mesh)
    elif cell.kind == "decode":
        local_b = first.to_local().shape[0]
        if cfg.encoder_decoder:
            memory = torch.zeros(
                (local_b, min(cell.seq, 4 * cfg.decoder_len), cfg.d_model),
                dtype=cfg.dtype, device=TRACE)
            with par.use_mesh(mesh, axes, profile), torch.no_grad():
                placed.caches = model.init_caches(memory, cell.seq)
        else:
            placed.caches = model.init_caches(local_b, cell.seq)
    return placed


def _trace(cfg, shape_name: str, mesh, opt_name: str):
    """Place and trace one step of ``cfg`` (any depth): a train cell's
    forward and backward (``step.grads``), a prefill or a decode step.
    Returns (CostMode, out bytes, alias bytes, seconds to place, seconds
    to trace)."""
    from repro_torch.models import registry
    from repro_torch.parallel import util as par
    from repro_torch.roofline import hlo_cost
    from repro_torch.train import loop as loop_lib
    from repro_torch.train import optimizer as opt_lib

    cell = registry.SHAPES[shape_name]
    t0 = time.time()
    placed = _place(cfg, shape_name, mesh, opt_name)
    t_place = time.time() - t0
    mode = hlo_cost.CostMode()
    mode.hold(placed.args())
    task, model, profile = placed.task, placed.model, cfg.sharding_profile
    local = {k: v.to_local() for k, v in placed.batch.items()}
    t0 = time.time()
    with mode:
        if cell.kind == "train":
            loop_lib.make_train_step(
                task, opt_lib.OptConfig(name=opt_name),
                microbatches=cfg.train_microbatches,
                param_shardings=placed.param_specs).grads(model,
                                                          placed.batch)
            out_bytes = alias_bytes = 0
        else:
            with par.use_mesh(mesh, placed.axes, profile):
                if cell.kind == "prefill":
                    out = task.prefill(model, local)
                    alias_bytes = 0
                else:
                    step_in = dict(local, pos=cell.seq // 2)
                    out = task.decode_step(model, step_in, placed.caches)
                    alias_bytes = _nbytes(placed.caches)
            out_bytes = _nbytes(out)
    mode.sweep()
    return mode, out_bytes, alias_bytes, t_place, time.time() - t0


def _trace_update(cfg, shape_name: str, mesh, opt_name: str):
    """Trace the optimizer's update of the full-depth model (its cost
    grows with the parameters, not a layer's activations) on gradients
    placed as the parameters are, counted live."""
    import torch

    from repro_torch.roofline import hlo_cost
    from repro_torch.train import loop as loop_lib
    from repro_torch.train import optimizer as opt_lib

    placed = _place(cfg, shape_name, mesh, opt_name)
    step = loop_lib.make_train_step(placed.task,
                                    opt_lib.OptConfig(name=opt_name),
                                    param_shardings=placed.param_specs)
    params = loop_lib.named_params(placed.model)
    mode = hlo_cost.CostMode()
    mode.hold(placed.args())
    with mode:
        grads = {k: torch.zeros_like(p) for k, p in params.items()}
        step.update(placed.model, placed.opt_state, grads,
                    torch.zeros((), device=TRACE))
        del grads
    mode.sweep()
    return mode


def _extrapolate(a: float, b: float, repeats: float) -> float:
    """A quantity traced at one and at two repeats of the layer pattern,
    at ``repeats`` of them (the layers repeat, so it is linear)."""
    return a + (repeats - 1.0) * (b - a)


def lower_cell(arch: str, shape_name: str, multi_pod: bool, mesh,
               opt_name: str | None = None, cfg_overrides: dict | None = None,
               reduced: bool = False, mesh_shape=None) -> dict:
    """Place and trace one cell on ``mesh``.  Returns the record.

    Every layer of a pattern repeat runs the same ops, so the forward and
    backward (or the serving step) are traced at one and at two repeats of
    the pattern and each count (FLOPs, bytes, collectives, the live peak)
    extrapolated linearly to the full depth, as the reference multiplies
    its scanned layer body by the trip count.  A train cell's optimizer
    update is traced at the full depth; its peak is the larger of the
    two phases'.  The arguments (parameters, optimizer state, the batch's
    rows, a decode cell's caches) are counted at the full depth."""
    from repro_torch import configs
    from repro_torch.models import registry
    from repro_torch.roofline import analysis as roof
    from repro_torch.roofline import hlo_cost

    cfg = configs.get_config(arch, reduced=reduced)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    opt_name = opt_name or cfg.optimizer
    cell = registry.SHAPES[shape_name]
    one, two, repeats = _depths(cfg)
    m1, o1, al1, p1, t1 = _trace(one, shape_name, mesh, opt_name)
    m2, o2, al2, p2, t2 = _trace(two, shape_name, mesh, opt_name)
    full = _place(cfg, shape_name, mesh, opt_name)
    arg_bytes = _nbytes(full.args())
    c1, c2 = hlo_cost.analyze(m1), hlo_cost.analyze(m2)
    cu, peak_update = hlo_cost.HLOCost(0.0, 0.0, 0.0, {}, {}, {}), 0
    if cell.kind == "train":
        mu = _trace_update(cfg, shape_name, mesh, opt_name)
        cu, peak_update = hlo_cost.analyze(mu), mu.peak_live

    def ext(x, y, u=0.0):
        return _extrapolate(float(x), float(y), repeats) + float(u)

    def ext_dict(x, y, u):
        return {k: ext(x.get(k, 0.0), y.get(k, 0.0), u.get(k, 0.0))
                for k in set(x) | set(y) | set(u)}

    hc = hlo_cost.HLOCost(
        flops=ext(c1.flops, c2.flops, cu.flops),
        bytes_accessed=ext(c1.bytes_accessed, c2.bytes_accessed,
                           cu.bytes_accessed),
        coll_wire_bytes=ext(c1.coll_wire_bytes, c2.coll_wire_bytes,
                            cu.coll_wire_bytes),
        coll_by_op=ext_dict(c1.coll_by_op, c2.coll_by_op, cu.coll_by_op),
        coll_counts=ext_dict(c1.coll_counts, c2.coll_counts,
                             cu.coll_counts),
        coll_by_link=ext_dict(c1.coll_by_link, c2.coll_by_link,
                              cu.coll_by_link))
    if cell.kind == "train":
        # the update writes the parameters and optimizer state in place
        out_bytes = alias_bytes = _nbytes(full.args()[0]) + \
            _nbytes(full.opt_state)
    else:
        out_bytes, alias_bytes = int(ext(o1, o2)), int(ext(al1, al2))
    temp = int(max(ext(m1.peak_live, m2.peak_live), peak_update)
               - max(out_bytes - alias_bytes, 0))
    mflops = roof.model_flops(cfg, cell)
    rl = roof.roofline_from_hlo(hc, mesh.size(), mflops)
    differences = []
    if cell.kind == "decode":
        differences.append(
            "decode caches: this rank's batch rows whole over 'model' "
            "(the reference cuts their longest axis over it)")
    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": _mesh_tag(multi_pod, mesh_shape),
        "kind": cell.kind,
        "profile": cfg.sharding_profile,
        "optimizer": opt_name if cell.kind == "train" else None,
        "status": "ok",
        "lower_s": round(p1 + p2, 1),
        "compile_s": round(t1 + t2, 1),
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": temp,
            "alias_bytes": alias_bytes,
            "peak_per_device_gb": round(
                (arg_bytes + temp + out_bytes - alias_bytes) / 2**30, 3),
        },
        "cost_raw_backend": {"flops": hc.flops,
                             "bytes accessed": hc.bytes_accessed},
        "hlo_cost": hc.row(),
        "top_buffers_gb": [[n, round(g, 3)]
                           for n, g in hlo_cost.top_buffers(m2, n=10)],
        "roofline": rl.row(),
        "depth_traced": [one.n_layers, two.n_layers, cfg.n_layers],
        "differences": differences,
    }


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
             mesh, opt_name: str | None = None, reduced: bool = False,
             mesh_shape=None) -> dict:
    from repro_torch.models import registry

    tag = _mesh_tag(multi_pod, mesh_shape)
    os.makedirs(os.path.join(out_dir, tag), exist_ok=True)
    path = os.path.join(out_dir, tag, f"{arch}__{shape_name}.json")
    if not registry.cell_is_applicable(arch, shape_name):
        record = {
            "arch": arch, "shape": shape_name, "mesh": tag,
            "status": "skipped",
            "reason": "full-attention arch; long_500k requires sub-quadratic "
                      "sequence mixing",
        }
    else:
        try:
            record = lower_cell(arch, shape_name, multi_pod, mesh, opt_name,
                                reduced=reduced, mesh_shape=mesh_shape)
        except Exception as e:  # noqa: BLE001 — recorded, sweep continues
            record = {
                "arch": arch, "shape": shape_name, "mesh": tag,
                "status": "error", "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-4000:],
            }
    with open(path, "w") as f:
        json.dump(record, f, indent=1)
    return record


def main(argv=None):
    from repro_torch import configs
    from repro_torch.models import registry

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(configs.ARCH_IDS))
    ap.add_argument("--shape", choices=list(registry.SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--optimizer", default=None,
                    help="override the config's optimizer")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--reduced", action="store_true",
                    help="the CPU-sized config of the arch (tests)")
    ap.add_argument("--mesh-shape", default=None, metavar="D,M",
                    help="a small (data, model) mesh in place of the "
                         "production one (tests)")
    args = ap.parse_args(argv)

    cells = []
    if args.all:
        for arch in configs.ARCH_IDS:
            for shape in registry.SHAPES:
                cells.append((arch, shape))
    elif args.arch and args.shape:
        cells.append((args.arch, args.shape))
    else:
        ap.error("--arch/--shape or --all")

    mesh_shape = (tuple(int(n) for n in args.mesh_shape.split(","))
                  if args.mesh_shape else None)
    world = (math.prod(mesh_shape) if mesh_shape
             else 512 if args.multi_pod else 256)
    fake_process_group(world)
    mesh = make_mesh(args.multi_pod, mesh_shape)
    tag = _mesh_tag(args.multi_pod, mesh_shape)
    for arch, shape in cells:
        t0 = time.time()
        rec = run_cell(arch, shape, args.multi_pod, args.out, mesh,
                       args.optimizer, args.reduced, mesh_shape)
        status = rec["status"]
        extra = ""
        if status == "ok":
            r = rec["roofline"]
            extra = (f" mem/dev={rec['memory']['peak_per_device_gb']}GB "
                     f"terms(c/m/x)={r['compute_s']:.3e}/{r['memory_s']:.3e}/"
                     f"{r['collective_s']:.3e}s bottleneck={r['bottleneck']}")
        elif status == "error":
            extra = " " + rec["error"][:160]
        print(f"[{tag}] {arch} x {shape}: {status} "
              f"({time.time() - t0:.0f}s){extra}", flush=True)


if __name__ == "__main__":
    main()
