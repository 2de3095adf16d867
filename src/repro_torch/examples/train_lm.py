"""End-to-end training driver: train an LM for a few hundred steps with the
full production loop (prefetch pipeline, async checkpoints, watchdog,
resume). Port of the JAX package's examples/train_lm.py. Defaults to a
small slice of smollm-135m; pass --full-config to train the real 135M
architecture (same code path) on the card, through the flash kernel and
its hand-written gradient.

  PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 200
  PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 300 --full-config --batch 8 --seq 512

--device cpu runs the plain versions of the kernels; the default, cuda,
raises at once without a card.
"""
import argparse
import dataclasses
import os
import tempfile

from repro_torch.configs import get_config
from repro_torch.launch.train import train_loop


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full-config", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if not args.full_config:
        # ~20M-param same-family slice: deep enough to show real learning
        cfg = dataclasses.replace(
            cfg.reduce_for_smoke(),
            num_layers=4, d_model=256, num_heads=8, num_kv_heads=2,
            head_dim=32, d_ff=1024, vocab_size=2048,
        )
    print(f"training {cfg.name}: {cfg.num_layers}L d={cfg.d_model} "
          f"vocab={cfg.vocab_size}")
    out = train_loop(
        cfg, steps=args.steps, batch=args.batch, seq=args.seq,
        ckpt_dir=args.ckpt_dir, ckpt_every=50, device=args.device,
    )
    first = out["losses"][0]
    last = out["final_loss"]
    print(f"loss {first:.3f} -> {last:.3f} over {len(out['losses'])} steps "
          f"(stragglers flagged: {out['stragglers']})")
    if not last < first:
        raise AssertionError("model must learn on the synthetic pattern")


if __name__ == "__main__":
    main()
