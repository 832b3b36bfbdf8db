"""One rank of a gloo process group for the LM mesh and the cross-pod
merge tests: ``python tests/torch_lm_rank_worker.py SPEC RANK``.

SPEC is a pickle: ``{"suite": "outer" | "mesh", "world": n, "store":
path, "inputs": path, "out": prefix}``.  The rank meets the others
through a ``FileStore`` at ``store`` (never a TCP port), runs the suite
on the CPU and pickles its results to ``f"{out}.{rank}"``.

  * ``outer``: ``core/local_sgd.outer_merge`` over a ``("pod",)`` mesh of
    ``world`` ranks for every case of ``inputs`` (pod ``rank``'s
    parameters, liveness, loss and draw).
  * ``mesh``: over a 2 x 2 ``("data", "model")`` mesh, ``constrain`` of
    DTensor activations, the MoE FFN of
    ``inputs`` (the expert-parallel dispatch against the scatter path on
    the whole batch, outputs and gradients, at each capacity factor) and
    ``Trainer(mesh=...)`` on reduced smollm-135m and qwen2-moe-a2.7b
    under ``fsdp_tp`` against the mesh-less ``Trainer`` (rank 0).
"""
import os
import pickle
import sys
from datetime import timedelta

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

TRAIN_STEPS = 3
TRAIN_ARCHS = ("smollm-135m", "qwen2-moe-a2.7b")


def moe_config(capacity_factor: float):
    """The reference helper's MoE config (tests/helpers/
    moe_shardmap_check.py): 8 experts, top-2, d 32, ffn 16, fsdp_tp."""
    from repro_torch import configs

    return configs.get_config("qwen2-moe-a2.7b", reduced=True).reduced(
        n_experts=8, top_k=2, moe_d_ff=16, d_model=32,
        capacity_factor=capacity_factor, sharding_profile="fsdp_tp",
        dtype=torch.float32)


def train_config(arch: str):
    from repro_torch import configs

    return configs.get_config(arch, reduced=True).reduced(
        sharding_profile="fsdp_tp", dtype=torch.float32)


def _outer(spec, rank):
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core import local_sgd

    mesh = init_device_mesh("cpu", (spec["world"],), mesh_dim_names=("pod",))
    with open(spec["inputs"], "rb") as f:
        cases = pickle.load(f)
    out = {}
    for name, case in cases.items():
        cfg = local_sgd.OuterConfig(**case["cfg"])
        params = {k: torch.from_numpy(v[rank]) for k, v in
                  case["params"].items()}
        anchor = {k: torch.from_numpy(v) for k, v in case["anchor"].items()}
        state = local_sgd.OuterState.init(anchor, cfg)
        if case.get("momentum") is not None:
            state.momentum = {k: torch.from_numpy(v) for k, v in
                              case["momentum"].items()}
        live = case.get("liveness")
        merged, new = local_sgd.outer_merge(
            params, state, cfg, mesh=mesh,
            local_loss=float(case["loss"][rank]),
            draw=float(case["draw"][rank]),
            liveness=None if live is None else float(live[rank]))
        out[name] = {
            "merged": {k: v.numpy() for k, v in merged.items()},
            "momentum": None if new.momentum is None else
            {k: v.numpy() for k, v in new.momentum.items()}}
    return out


def _moe(mesh, inputs, cf):
    """The MoE FFN on this rank's rows of the batch through the mesh,
    against the scatter path on the whole batch in this process."""
    from repro_torch.models import moe
    from repro_torch.parallel import sharding
    from repro_torch.parallel import util as par

    cfg = moe_config(cf)

    def params():
        gen = torch.Generator().manual_seed(0)
        p = moe.init_moe(gen, cfg, "cpu")
        with torch.no_grad():
            for k, t in p.named_parameters():
                t.copy_(torch.from_numpy(inputs["params"][k]))
        return p.requires_grad_(True)

    x_full = torch.from_numpy(inputs["x"])
    # the scatter path on the whole batch: sum(out^2) + aux
    ref_p = params()
    xr = x_full.clone().requires_grad_(True)
    out_r, aux_r = moe._apply_moe_scatter(ref_p, xr, cfg)
    (torch.sum(out_r ** 2) + aux_r).backward()

    p = params()
    specs = sharding.param_shardings(p, mesh, cfg.sharding_profile)
    par.distribute_module(p, specs, mesh)
    p.requires_grad_(True)
    rows = x_full.shape[0] // 2
    d_rank = mesh.get_local_rank("data")
    lo = d_rank * rows
    x = x_full[lo:lo + rows].clone().requires_grad_(True)
    calls = []
    real = moe._apply_moe_shardmap

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    moe._apply_moe_shardmap = counted
    try:
        with par.use_mesh(mesh, ("data",), cfg.sharding_profile):
            with par.local_params(p):
                out, aux = moe.apply_moe(p, x, cfg)
                e_loc = p["wi"].shape[0]
            # this rank's share of sum(out^2) + aux over the global batch
            (torch.sum(out ** 2) + aux / 2).backward()
    finally:
        moe._apply_moe_shardmap = real
    missing = [k for k, t in p.named_parameters() if t.grad is None]
    assert not missing, missing
    grads = par.full_tree({k: t.grad for k, t in p.named_parameters()})
    return {
        "calls": len(calls), "e_loc": e_loc, "rows": (lo, lo + rows),
        "out": out.detach().numpy(), "aux": float(aux),
        "x_grad": x.grad.numpy(),
        "grads": {k: g.numpy() for k, g in grads.items()},
        "scatter_out": out_r.detach()[lo:lo + rows].numpy(),
        "scatter_aux": float(aux_r),
        "scatter_x_grad": xr.grad[lo:lo + rows].numpy(),
        "scatter_grads": {k: t.grad.numpy() for k, t in
                          ref_p.named_parameters()},
    }


def _train(arch, mesh):
    from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig
    from repro_torch.models import registry
    from repro_torch.parallel import util as par
    from repro_torch.train import loop
    from repro_torch.train import optimizer as opt_lib

    cfg = train_config(arch)
    task = registry.make_task(cfg, "cpu")
    pipe = TokenPipeline(TokenPipelineConfig(
        vocab_size=cfg.vocab_size, seq_len=16, global_batch=4, seed=0))
    # SGD with momentum: AdamW divides each update by its gradient's own
    # size, so an entry whose gradient is rounding noise moves a whole step
    # either way and the mesh's other summation order shows; SGD keeps the
    # update proportional to the gradient
    trainer = loop.Trainer(task, pipe, opt_lib.OptConfig(
        name="sgd", learning_rate=0.1, warmup_steps=1),
        loop.TrainConfig(steps=TRAIN_STEPS, log_every=0), mesh=mesh)
    params, _ = trainer.run(seed=0)
    return {"history": list(trainer.history),
            "params": {k: v.numpy() for k, v in par.full_tree(
                loop.named_params(params)).items()}}


def _constrain(mesh):
    """``constrain`` of DTensor activations under the ambient mesh: the
    placements it gives, and whether the values stay whole."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.parallel import util as par

    out = {}
    for name, shape, axes in (
            ("batch", (4, 6, 2), (("pod", "data"), None, "model")),
            ("odd", (3, 6, 2), (("data", "model"), None, None)),
            ("batch_dp", (4, 6), None)):
        x = torch.arange(float(torch.Size(shape).numel())).reshape(shape)
        dx = distribute_tensor(x, mesh, [Replicate(), Replicate()])
        with par.use_mesh(mesh):
            got = (par.constrain_batch(dx, "dp") if axes is None
                   else par.constrain(dx, axes))
        out[name] = ([str(p) for p in got.placements],
                     bool(torch.equal(got.full_tensor(), x)))
    return out


def _mesh_suite(spec, rank):
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    with open(spec["inputs"], "rb") as f:
        inputs = pickle.load(f)
    out = {"constrain": _constrain(mesh)}
    out["moe"] = {cf: _moe(mesh, inputs[cf], cf) for cf in inputs}
    out["train"] = {arch: _train(arch, mesh) for arch in TRAIN_ARCHS}
    if rank == 0:
        out["train_plain"] = {arch: _train(arch, None)
                              for arch in TRAIN_ARCHS}
    return out


def main(spec_path: str, rank: int):
    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(spec["store"], spec["world"]),
        world_size=spec["world"], rank=rank,
        timeout=timedelta(seconds=240))
    try:
        run = {"outer": _outer, "mesh": _mesh_suite}[spec["suite"]]
        result = run(spec, rank)
    finally:
        dist.destroy_process_group()
    with open(f"{spec['out']}.{rank}", "wb") as f:
        pickle.dump(result, f)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
