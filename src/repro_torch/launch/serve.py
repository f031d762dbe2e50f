"""Serving launcher: real-execution PaDG serving on the port's engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
        --instances 2 --requests 12 --rate 4 [--device cpu]

Counterpart of ``repro.launch.serve``: the same reduced model and request
trace, served on ``--device`` (``cuda`` by default).
"""
import argparse
import dataclasses


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--instances", type=int, default=2)
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--rate", type=float, default=4.0)
    ap.add_argument("--out-tokens", type=int, default=6)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    import numpy as np

    from repro_torch.configs import get_smoke_config
    from repro_torch.core.request import Request
    from repro_torch.core.slo import SLO
    from repro_torch.serving.engine import EngineConfig
    from repro_torch.serving.padg_server import PaDGServer

    cfg = get_smoke_config(args.arch)
    cfg = dataclasses.replace(cfg, num_layers=2, d_model=128,
                              num_heads=2, num_kv_heads=1, head_dim=64,
                              d_ff=256, vocab_size=512)
    if cfg.is_encoder:
        raise SystemExit(f"{args.arch} is encoder-only: no decode serving")

    rng = np.random.default_rng(0)
    reqs, t = [], 0.0
    for i in range(args.requests):
        plen = int(rng.integers(4, 24))
        reqs.append(Request(
            rid=i, arrival_time=t, prompt_len=plen,
            output_len=args.out_tokens,
            prompt_tokens=[int(x) for x in rng.integers(2, 500, plen)]))
        t += float(rng.exponential(1.0 / args.rate))

    with PaDGServer(cfg, n_instances=args.instances,
                    slo=SLO(ttft=60.0, tpot=10.0),
                    econf=EngineConfig(max_batch=args.max_batch,
                                       max_seq_len=96, eos_token=-1,
                                       device=args.device)) as server:
        print(f"serving {len(reqs)} requests on {args.instances} instances "
              f"({cfg.name}, {cfg.param_count()/1e6:.1f}M params, "
              f"{args.device})")
        stats = server.serve(reqs)
    for k, v in stats.summary().items():
        print(f"  {k} = {v}")


if __name__ == "__main__":
    main()
