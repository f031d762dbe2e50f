"""Train a ~25M-parameter llama3-family model (``--big``: ~100M) for a
few hundred steps on the synthetic corpus with the PyTorch port; loss
must drop.  Counterpart of ``examples/train_small.py``.

    PYTHONPATH=src python examples/train_small_torch.py [--steps 150]
        [--device cpu|cuda]

``--device cuda`` (the default) raises when no CUDA device is present.
"""
import argparse
import dataclasses


def config(big: bool = False):
    from repro_torch.configs import get_smoke_config
    cfg = get_smoke_config("llama3-8b")
    if big:
        return dataclasses.replace(
            cfg, name="llama3-100m", num_layers=8, d_model=768,
            num_heads=12, num_kv_heads=4, head_dim=64, d_ff=2048,
            vocab_size=512)
    return dataclasses.replace(
        cfg, name="llama3-25m", num_layers=4, d_model=512, num_heads=8,
        num_kv_heads=4, head_dim=64, d_ff=1408, vocab_size=512)


def batches(cfg, batch: int, seq: int):
    from repro_torch.data.pipeline import (ByteTokenizer, TokenDataset,
                                           synthetic_corpus)
    ds = TokenDataset.from_texts(synthetic_corpus(1024),
                                 ByteTokenizer(cfg.vocab_size))
    return ds.batches(batch, seq)


def run(steps: int, batch: int = 8, seq: int = 128, big: bool = False,
        device: str = "cuda", checkpoint=None, log_every: int = 20):
    """The training run: its losses."""
    from repro_torch.training.optimizer import AdamW
    from repro_torch.training.train_loop import train

    cfg = config(big)
    print(f"{cfg.name}: {cfg.param_count()/1e6:.1f}M params")
    _, losses = train(cfg, batches(cfg, batch, seq), steps=steps,
                      optimizer=AdamW(lr=6e-4), log_every=log_every,
                      checkpoint_path=checkpoint, device=device)
    return losses


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--big", action="store_true",
                    help="~100M params (default ~25M)")
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    args = ap.parse_args()

    losses = run(args.steps, args.batch, args.seq, args.big, args.device,
                 checkpoint="build/ckpt/train_small.npz")
    drop = losses[0] - min(losses[-10:])
    print(f"\nloss {losses[0]:.3f} -> {losses[-1]:.3f} (drop {drop:.3f})")
    assert drop > 0.5, "training must reduce loss"


if __name__ == "__main__":
    main()
