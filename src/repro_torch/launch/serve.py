"""Serving launcher: batched prefill + decode on any ported zoo arch.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b \
        --reduced --batch 4 --prompt-len 16 --max-new 32 [--device cpu]

A port of ``repro.launch.serve``: the reference's flags, defaults and two
printed lines, plus ``--device`` (default ``cuda``).  Parameters come from
a ``torch.Generator`` seeded with ``--seed``; prompts from numpy's
``default_rng(seed)``, as in the reference.  Archs the port has no layers
for raise ``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs, resolve_device
from repro_torch.models import registry, vlm_stub
from repro_torch.serve import engine as engine_lib


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(configs.ARCH_IDS))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the model runs: 'cuda' (the default) or "
                         "'cpu'")
    return ap


def main(argv=None) -> np.ndarray:
    """Run the launcher on ``argv``; returns the generated ids."""
    args = build_parser().parse_args(argv)

    device = resolve_device(args.device)
    cfg = configs.get_config(args.arch, reduced=args.reduced)
    task = registry.make_task(cfg, device)
    params = task.init(torch.Generator(device=device).manual_seed(args.seed))
    eng = engine_lib.Engine(task, params)

    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(
        0, cfg.vocab_size, size=(args.batch, args.prompt_len)).astype(np.int32)
    extra = {}
    if cfg.vision_tokens:
        extra["patch_embeds"] = vlm_stub.synthetic_patch_embeds(
            torch.Generator(device=device).manual_seed(1), args.batch,
            cfg.vision_tokens, cfg.d_model, cfg.dtype)

    gcfg = engine_lib.GenerateConfig(
        max_new_tokens=args.max_new, temperature=args.temperature,
        seed=args.seed)
    t0 = time.time()
    out = eng.generate(prompts, gcfg, extra_batch=extra or None)
    dt = time.time() - t0
    n_tok = out.size
    # the reference's line, word for word; the port compiles nothing, so
    # its "compile" is the first call's warm-up
    print(f"generated {n_tok} tokens in {dt:.2f}s "
          f"({n_tok / dt:.1f} tok/s incl. compile)")
    print("first sequence:", out[0][:16].tolist())
    return out


if __name__ == "__main__":
    main()
