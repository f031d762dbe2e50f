"""The whole run at a CPU size with the timed path broken underneath:
``correct`` has to come out false for each fault a served cell can have.
(The look for a chip is the command's; ``run_cell`` does the rest.)  The
exchange between chips does not exist in a one-chip cell."""
import pytest

from ecobench_testlib import cpu_run, tiny

CELL = "qwen2-72b.longbench"


def _run(fault=None, seed=2**31 + 3):
    shrink = tiny(rate=6.0)

    def all_finished(spec):
        spec = shrink(spec)
        spec["mix"]["check"] = {"tokens": 10**6, "requests": 10**6,
                                "min_compared": 8}
        return spec
    return cpu_run(CELL, seed, shrink=all_finished, fault=fault)


def _engines(server):
    return [inst.engine.engine for inst in server.instances]


def test_sound_run_is_correct():
    out = _run()
    assert out["correct"] is True
    assert out["checks"]["widest_logit_gap"]["value"] < 1e-3


def test_token_altered_where_produced():
    def fault(server):
        for eng in _engines(server):
            step = eng.decode_step

            def altered(_f=step, _e=eng):
                live = [r for r in _e.slot_req if r is not None]
                out = _f()
                for r in live:
                    r.generated[-1] = (r.generated[-1] + 1) % 256
                return out
            eng.decode_step = altered
    out = _run(fault)
    assert out["correct"] is False


def test_prefill_state_left_unchanged(monkeypatch):
    import repro_torch.serving.engine as E
    monkeypatch.setattr(E, "write_slot", lambda *a, **k: None)
    out = _run()
    assert out["correct"] is False


def test_half_the_batch_left_out(monkeypatch):
    import repro_torch.serving.engine as E
    real = E.forward

    def half(params, cfg, batch, **kw):
        logits, cache = real(params, cfg, batch, **kw)
        if kw.get("cache") is not None:     # a decode step: odd rows
            logits = logits.clone()         # take the even rows' results
            logits[1::2] = logits[0::2][:logits[1::2].shape[0]]
        return logits, cache
    monkeypatch.setattr(E, "forward", half)
    out = _run()
    assert out["correct"] is False


@pytest.mark.parametrize("dtype", ["bfloat16"])
def test_bf16_program_sound_at_cpu_size(dtype):
    out = cpu_run(CELL, 77, shrink=tiny(dtype=dtype, rate=6.0))
    assert out["correct"] is True


def test_warm_up_measures_every_executor():
    """Both instances' executors leave the warm-up with measured gains:
    their predictions differ from an unobserved executor's."""
    import torch
    from ecobench.harness import bench, serve, traffic
    from ecobench.harness.clock import BenchClock
    from ecobench.harness.model import model_of
    from ecobench.harness.weights import draw
    from repro_torch.serving.engine import MeasuredExecutor
    spec = tiny(rate=6.0)(bench.cell_spec(CELL))
    conf, mix = spec["conf"], spec["mix"]
    m = model_of(conf)
    n_threads = torch.get_num_threads()
    torch.set_num_threads(2)
    server, _ = serve.build(conf, m, mix,
                            lambda: draw(m, 5, torch.float32, "cpu"),
                            "cpu", BenchClock(), serve.Log(), torch.float32)
    engines = serve.engines_of(server)
    warm = traffic.warmup(mix, 5, m.vocab, 2)
    serve.warm_engines(engines, warm, 4)
    try:
        for eng in engines:
            fresh = MeasuredExecutor(seed_model=None)
            fresh.__dict__.update(
                {k: v for k, v in eng.executor.__dict__.items()
                 if not k.endswith("_gain")})
            assert eng.executor.decode_time(2, ctx_sum=100) != \
                fresh.decode_time(2, ctx_sum=100)
            assert eng.executor.prefill_time([40]) != \
                fresh.prefill_time([40])
            assert all(r is None for r in eng.slot_req)
    finally:
        server.shutdown()
        torch.set_num_threads(n_threads)
