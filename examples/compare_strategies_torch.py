"""Strategy comparison on the simulated 32x L20 cluster (a mini Fig. 8):
EcoServe (PaDG) vs vLLM / Sarathi (NoDG) vs DistServe / MoonCake (FuDG)
serving Llama-30B, under any arrival scenario (poisson / bursty / diurnal
/ ramp / trace replay).  The PyTorch port's counterpart of
``compare_strategies.py``: it imports ``repro_torch`` only, takes the same
command line and prints the same table.

    PYTHONPATH=src python examples/compare_strategies_torch.py \
        [--rate 24] [--scenario bursty]
"""
import argparse


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rate", type=float, default=24.0)
    ap.add_argument("--model", default="llama-30b")
    ap.add_argument("--workload", default="sharegpt",
                    choices=["alpaca", "sharegpt", "longbench"])
    ap.add_argument("--scenario", default="poisson",
                    choices=["poisson", "bursty", "diurnal", "ramp",
                             "replay"])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    from repro_torch.baselines import make_system
    from repro_torch.configs import get_config
    from repro_torch.core.slo import DATASET_SLOS
    from repro_torch.simulator.cost_model import GPU_L20, InstanceCostModel
    from repro_torch.simulator.metrics import run_once
    from repro_torch.simulator.scenarios import make_scenario

    cost = InstanceCostModel(cfg=get_config(args.model), hw=GPU_L20, tp=4)
    slo = DATASET_SLOS[args.workload]
    scenario = make_scenario(args.scenario, args.workload, args.rate,
                             seed=args.seed)
    print(f"{args.model} x {args.workload} [{args.scenario}] @ "
          f"{args.rate} req/s, 8 instances TP=4 on L20+10GbE "
          f"(SLO: ttft={slo.ttft}s, tpot={slo.tpot*1e3:.0f}ms)\n")
    labels = {
        "ecoserve": "EcoServe (PaDG)",
        "ecoserve++": "EcoServe++ (beyond-paper)",
        "vllm": "vLLM (NoDG)",
        "sarathi": "Sarathi (NoDG+chunked)",
        "distserve": "DistServe (FuDG intra)",
        "mooncake": "MoonCake (FuDG inter)",
    }
    print(f"{'system':28}{'attainment':>11}{'ttft_p90':>10}{'tpot_p90':>10}")
    for name, label in labels.items():
        m = run_once(lambda: make_system(name, cost, 8, slo), scenario,
                     args.rate, slo, duration=60.0, seed=args.seed)
        print(f"{label:28}{m['attainment']:11.2f}"
              f"{m.get('ttft_p90', 0):10.2f}{m.get('tpot_p90', 0):10.3f}")


if __name__ == "__main__":
    main()
