#!/usr/bin/env python3
"""The loss trajectory of the port's GPT-2 345M training on one NVIDIA card,
variant by variant.

    python3 tools/torch_train_trajectory.py --seed 12 --steps 12 \
        --variants O0-plain,O0-fused,O1-plain,O1-fused

Each variant builds GPT-2 345M with bf16 weights from ``--seed``, trains it
with ``chip_smoke.py``'s rung settings (AdamW lr 2.5e-4, beta2 0.95, weight
decay 0.1, fp32 masters, B=8, S=1024, two seeded batches in turn) under the
variant's amp level (O0: none; O1: bf16 ``auto_cast``) and loss (plain
cross entropy on the full logits, or the fused chunked loss), and prints
one JSON line a step: the step's loss, its global gradient norm, and the
loss on batch 0 after the step, evaluated without grad and with grad (the
two must agree). It separates what the port computes from what this
optimizer does on two repeated batches of random tokens.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

import numpy as np
import torch

# the repository's root, so that the port imports when run as a script
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def run(variant: str, seed: int, steps: int) -> None:
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models import GPTForCausalLM, gpt2_medium
    from paddle_tpu_torch.optimizer import AdamW
    level, loss_kind = variant.split("-")
    cfg = gpt2_medium(fused_loss=loss_kind == "fused")
    model = GPTForCausalLM(cfg, device="cuda", dtype="bfloat16",
                           seed=seed).train()
    opt = AdamW(learning_rate=2.5e-4, beta1=0.9, beta2=0.95, epsilon=1e-8,
                weight_decay=0.1, parameters=model.named_parameters(),
                multi_precision=True)
    batches = [torch.from_numpy(np.random.RandomState(400 + i).randint(
        0, cfg.vocab_size, (8, 1024))).cuda() for i in range(2)]

    def cast():
        return (amp.auto_cast(level="O1", dtype="bfloat16") if level == "O1"
                else contextlib.nullcontext())

    b0 = batches[0]
    for step in range(steps):
        ids = batches[step % 2]
        with cast():
            _, loss = model(ids, labels=ids)
        loss.backward()
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(
            grads, 2, dtype=torch.float32)))
        opt.step()
        opt.clear_grad()
        with torch.no_grad(), cast():
            again = float(model(b0, labels=b0)[1])
        with cast():
            again_grad = float(model(b0, labels=b0)[1].detach())
        print(json.dumps({"variant": variant, "seed": seed, "step": step + 1,
                          "loss": float(loss.detach()),
                          "grad_norm": float(norm),
                          "batch0_after_no_grad": again,
                          "batch0_after_with_grad": again_grad}), flush=True)
    del model, opt
    torch.cuda.empty_cache()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=12)
    parser.add_argument("--steps", type=int, default=12)
    parser.add_argument("--variants", default="O0-plain,O0-fused,O1-plain,"
                        "O1-fused")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_train_trajectory: CUDA is not available",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    for variant in args.variants.split(","):
        run(variant, args.seed, args.steps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
