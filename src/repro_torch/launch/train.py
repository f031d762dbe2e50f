"""Training launcher: ``python -m repro_torch.launch.train --arch <id>
[...]``, the flags of ``repro.launch.train`` plus ``--device`` (the card
unless ``cpu`` is asked for).

As in the reference, ``--smoke`` is ``store_true`` with ``default=True``,
so the smoke config is always taken, and the batches come from
``TokenDataset`` (tokens only): an audio arch (hubert-xlarge) has no
frames here and fails at ``batch["frames"]`` as the reference does.
"""
import argparse
import dataclasses


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--d-model", type=int, default=0,
                    help="override d_model (e.g. ~100M-param runs)")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (the plain versions)")
    args = ap.parse_args()

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data.pipeline import (ByteTokenizer, TokenDataset,
                                           synthetic_corpus)
    from repro_torch.training.optimizer import AdamW
    from repro_torch.training.train_loop import train

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    updates = {}
    if args.d_model:
        heads = max(1, args.d_model // 64) if cfg.num_heads else 0
        updates.update(d_model=args.d_model, num_heads=heads,
                       num_kv_heads=max(1, heads // 2) if heads else 0,
                       head_dim=64 if heads else 0, d_ff=args.d_model * 4)
    if args.layers:
        updates.update(num_layers=args.layers)
    if updates:
        cfg = dataclasses.replace(cfg, **updates)

    print(f"training {cfg.name}: {cfg.param_count()/1e6:.1f}M params, "
          f"{args.steps} steps @ batch={args.batch} seq={args.seq} on "
          f"{args.device}")
    ds = TokenDataset.from_texts(synthetic_corpus(512),
                                 ByteTokenizer(cfg.vocab_size))
    batches = ds.batches(args.batch, args.seq)
    _, losses = train(cfg, batches, steps=args.steps,
                      optimizer=AdamW(lr=args.lr),
                      checkpoint_path=args.checkpoint, device=args.device)
    print(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"({'improved' if losses[-1] < losses[0] else 'NO IMPROVEMENT'})")


if __name__ == "__main__":
    main()
