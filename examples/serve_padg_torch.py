"""End-to-end driver of the PyTorch port: serve a small model through the
port's ``EcoServeAPI`` (text in, text out) over the full EcoServe stack,
on an NVIDIA GPU or, when asked, on the CPU.

Two PaDG instances serve a batch of prompts; Algorithm 1 routes stickily,
Algorithm 2 checks constraints, instances alternate prefill/decode slots
(temporal disaggregation).  Counterpart of ``examples/serve_padg.py``.

    PYTHONPATH=src python examples/serve_padg_torch.py [--device cpu|cuda]
        [--arch llama3-8b|qwen3-4b|chatglm3-6b|qwen2-vl-2b|...]

``--device cuda`` (the default) raises when no CUDA device is present.
"""
import argparse
import dataclasses

PROMPTS = [
    "the quick brown fox", "ecoserve rolls activation",
    "prefill then decode", "macro instances cooperate",
    "temporal disaggregation", "commodity interconnects win",
    "rolling activation keeps ttft low", "mitosis scales instances",
]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--new-tokens", type=int, default=6)
    args = ap.parse_args()

    from repro_torch.configs import get_smoke_config
    from repro_torch.core.slo import SLO
    from repro_torch.serving.api import EcoServeAPI
    from repro_torch.serving.engine import EngineConfig

    cfg = get_smoke_config(args.arch)
    cfg = dataclasses.replace(cfg, num_layers=2, d_model=128, num_heads=2,
                              num_kv_heads=1, head_dim=64, d_ff=256,
                              vocab_size=300)
    econf = EngineConfig(max_batch=4, max_seq_len=64, eos_token=-1,
                         device=args.device)
    streamed = []
    with EcoServeAPI(cfg, n_instances=2, slo=SLO(ttft=30.0, tpot=5.0),
                     econf=econf) as api:
        print(f"serving {len(PROMPTS)} prompts on 2 PaDG instances "
              f"({cfg.name}, {cfg.param_count() / 1e6:.1f}M params each, "
              f"{args.device})...")
        results = api.generate(
            PROMPTS, max_new_tokens=args.new_tokens,
            stream=lambda i, tok: streamed.append((i, tok)))
    print(f"streamed {len(streamed)} tokens")
    for r in results:
        tpot = (f"{r.avg_tpot_s * 1e3:.0f}ms" if r.avg_tpot_s is not None
                else "-")
        print(f"  {r.prompt!r}: ttft={r.ttft_s * 1e3:.0f}ms tpot={tpot} "
              f"tokens={r.tokens} text={r.text!r}")


if __name__ == "__main__":
    main()
