#!/usr/bin/env python3
"""The LM training loss over a short run at several learning rates, in
either package.

An arch of the zoo (smollm-135m by default, at its full width; ``--layers``
cuts its depth) trains on the synthetic Markov stream (``data/tokens.py``,
seed 0, ``--batch`` x ``--seq`` tokens a step) with adamw at the training
launcher's schedule (``warmup_steps = steps // 20``, at least 1, unless
``--warmup`` is given; cosine decay over the run) for ``--steps`` steps at
each of ``--lrs``, from one seeded init.  Each learning rate prints one
JSON line: its losses, and the mean of the first 4 and of the last 4.

    python3 tools/lm_lr_probe.py --lrs 3e-3 1e-3 3e-4      # the card
    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/lm_lr_probe.py \\
        --package repro --layers 2 --fp32 --lrs 3e-3 --save-init init
    PYTHONPATH=src python tools/lm_lr_probe.py --device cpu \\
        --layers 2 --fp32 --lrs 3e-3 --init-from init

``--package`` names the package that is imported (``repro_torch``, the
PyTorch port, the default, or ``repro``, the JAX package); only that one
is loaded.  The port draws its init from a ``torch.Generator`` seeded with
``--seed`` (as ``train.loop.Trainer.run`` does), the JAX package from
``PRNGKey(seed)``.  To hold the two packages' trajectories against each
other from one init, the JAX package saves its init with ``--save-init
DIR`` (its own checkpoint format) and the port starts from it with
``--init-from DIR`` (through ``convert.lm_params_from_reference``).
"""
import argparse
import dataclasses
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def _tuples(tree):
    """A tree read back from a checkpoint, its sequence nodes (dicts keyed
    "0", "1", ...) turned back into tuples."""
    if not isinstance(tree, dict):
        return tree
    if tree and all(k.isdigit() for k in tree):
        return tuple(_tuples(tree[str(i)]) for i in range(len(tree)))
    return {k: _tuples(v) for k, v in tree.items()}


def _opt_kw(args, lr):
    warm = args.warmup if args.warmup is not None else max(
        args.steps // 20, 1)
    return dict(name="adamw", learning_rate=lr, warmup_steps=warm,
                decay_steps=args.steps)


def _report(args, lr, losses):
    import numpy as np

    print(json.dumps({
        "package": args.package, "arch": args.arch, "layers": args.layers,
        "lr": lr, **{k: v for k, v in _opt_kw(args, lr).items()
                     if k.endswith("steps")},
        "first4": float(np.mean(losses[:4])),
        "last4": float(np.mean(losses[-4:])), "losses": losses}),
        flush=True)


def run_port(args):
    import torch

    from repro_torch import configs, convert
    from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig
    from repro_torch.models import registry
    from repro_torch.train import checkpoint, loop, optimizer

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = configs.get_config(args.arch)
    cfg = dataclasses.replace(
        cfg, n_layers=args.layers or cfg.n_layers,
        **({"dtype": torch.float32} if args.fp32 else {}))
    task = registry.make_task(cfg, args.device)
    for lr in args.lrs:
        pipe = TokenPipeline(TokenPipelineConfig(
            vocab_size=cfg.vocab_size, seq_len=args.seq,
            global_batch=args.batch, seed=0))
        opt_cfg = optimizer.OptConfig(**_opt_kw(args, lr))
        if args.init_from is None:
            trainer = loop.Trainer(task, pipe, opt_cfg, loop.TrainConfig(
                steps=args.steps, log_every=0, ckpt_dir=None))
            trainer.run(seed=args.seed, resume=False)
            losses = trainer.history
        else:
            tree, _ = checkpoint.load_tree(args.init_from, 0)
            params = convert.lm_params_from_reference(
                _tuples(tree), cfg, device=args.device)
            step = loop.make_train_step(task, opt_cfg)
            state = optimizer.init(loop.named_params(params), opt_cfg)
            losses = []
            for i in range(args.steps):
                params, state, m = step(params, state, pipe.batch(i))
                losses.append(float(m["loss"]))
        _report(args, lr, losses)


def run_reference(args):
    import jax
    import jax.numpy as jnp

    from repro import configs
    from repro.data.tokens import TokenPipeline, TokenPipelineConfig
    from repro.models import registry
    from repro.train import checkpoint, loop, optimizer

    cfg = configs.get_config(args.arch)
    cfg = dataclasses.replace(
        cfg, n_layers=args.layers or cfg.n_layers,
        **({"dtype": jnp.float32} if args.fp32 else {}))
    task = registry.make_task(cfg)
    init = jax.jit(task.init)(jax.random.PRNGKey(args.seed))
    if args.save_init:
        checkpoint.save(args.save_init, 0, init)
    for lr in args.lrs:
        pipe = TokenPipeline(TokenPipelineConfig(
            vocab_size=cfg.vocab_size, seq_len=args.seq,
            global_batch=args.batch, seed=0))
        opt_cfg = optimizer.OptConfig(**_opt_kw(args, lr))
        step = jax.jit(loop.make_train_step(task, opt_cfg))
        params, state = init, optimizer.init(init, opt_cfg)
        losses = []
        for i in range(args.steps):
            params, state, m = step(params, state, jax.tree.map(
                jnp.asarray, pipe.batch(i)))
            losses.append(float(m["loss"]))
        _report(args, lr, losses)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", default="repro_torch",
                    choices=["repro_torch", "repro"])
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers")
    ap.add_argument("--fp32", action="store_true",
                    help="fp32 activations in place of the config's")
    ap.add_argument("--lrs", type=float, nargs="+", default=[3e-3])
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--warmup", type=int, default=None)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="the port's device: 'cuda' (the default) or 'cpu'")
    ap.add_argument("--save-init", default=None, metavar="DIR",
                    help="repro only: save the init in DIR first")
    ap.add_argument("--init-from", default=None, metavar="DIR",
                    help="repro_torch only: start from the init in DIR")
    args = ap.parse_args(argv)
    if args.package == "repro":
        if args.init_from:
            ap.error("--init-from starts the port from the JAX package's "
                     "init: use it with --package repro_torch")
        run_reference(args)
    else:
        if args.save_init:
            ap.error("--save-init saves the JAX package's init: use it "
                     "with --package repro")
        run_port(args)


if __name__ == "__main__":
    main()
