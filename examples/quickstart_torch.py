"""Quickstart of the PyTorch port: build a reduced model from the
assigned-architecture pool, run a forward pass, a prefill->decode round,
and one hand-written kernel.  Counterpart of ``examples/quickstart.py``.

    PYTHONPATH=src python examples/quickstart_torch.py [--arch llama3-8b]
        [--device cpu|cuda]

``--device cuda`` (the default) raises when no CUDA device is present; on
``--device cpu`` the kernel's plain PyTorch version runs, and the kernel
line says so.
"""
import argparse

import numpy as np


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    args = ap.parse_args()

    import torch

    from repro_torch.configs import (available_archs, get_config,
                                     get_smoke_config)
    from repro_torch.models import (forward, init_cache, init_params,
                                    write_slot)

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("quickstart_torch: --device cuda but no CUDA "
                         "device is available (pass --device cpu)")

    print("available architectures:", ", ".join(available_archs()))
    full = get_config(args.arch)
    print(f"\n{full.name}: {full.num_layers}L d_model={full.d_model} "
          f"{full.num_heads}H (kv={full.num_kv_heads}) d_ff={full.d_ff} "
          f"vocab={full.vocab_size}  ~{full.param_count()/1e9:.1f}B params "
          f"[{full.citation}]")

    cfg = get_smoke_config(args.arch)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(cfg, gen, torch.float32, dev)
    print(f"reduced variant for CPU: {cfg.num_layers}L "
          f"d_model={cfg.d_model} -> {cfg.param_count()/1e6:.1f}M params")

    # forward pass
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 16)), device=dev)
    with torch.no_grad():
        if cfg.modality == "text":
            logits, _ = forward(params, cfg, {"tokens": toks})
            print("forward:", tuple(logits.shape), "logits ok:",
                  bool(torch.isfinite(logits).all()))

            # prefill -> decode
            _, pc = forward(params, cfg, {"tokens": toks},
                            return_cache=True)
            cache = init_cache(cfg, 2, 32, torch.float32, dev)
            for slot in range(2):
                write_slot(cache, {k: v[:, slot:slot + 1]
                                   for k, v in pc.items()}, slot, 16)
            dec_logits, cache = forward(
                params, cfg, {"tokens": toks[:, -1:]}, cache=cache,
                cache_len=torch.full((2,), 16, dtype=torch.int32,
                                     device=dev))
            print("decode step:", tuple(dec_logits.shape))

    # one hand-written kernel against its plain version
    from repro_torch.kernels import flash_prefill as FP
    rng = np.random.default_rng(1)
    q, k, v = (torch.as_tensor(rng.normal(size=s), dtype=torch.float32,
                               device=dev)
               for s in ((1, 128, 4, 64), (1, 128, 2, 64), (1, 128, 2, 64)))
    FP.flash_prefill.launches = 0
    out = FP.flash_prefill(q, k, v, causal=True)
    ref = FP.flash_prefill_plain(q, k, v, causal=True)
    err = float((out - ref).abs().max())
    if FP.flash_prefill.launches:
        print(f"flash_prefill CUDA kernel ({FP.flash_prefill.launches} "
              f"launch) vs its plain version: max |err| = {err:.2e}")
    else:
        print("flash_prefill: the plain version ran (CPU tensors, no kernel "
              f"launched); max |err| against itself = {err:.2e}")


if __name__ == "__main__":
    main()
