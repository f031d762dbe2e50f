"""The decode step in pieces split at ``decode_attention``
(``repro_torch.serving.decode_graph``) on the CPU, where the pieces run
eagerly: tokens and logits bit-equal to ``forward``'s decode under slot
churn, the kernel called once a layer through the module attribute that
the benchmark's shim replaces, the rule that decides where the graphs
engage, and the engine dropping its pieces when its weights or cache are
replaced.

The capture itself runs on a CUDA device only: the ``card`` tests hold a
graphed engine against an eager one on the same weights there (run them
with ``PYTHONPATH=src python3 -m pytest -q tests/test_torch_decode_graph.py``
on the card)."""
import dataclasses
import gc
import os
import random
import weakref

import pytest

torch = pytest.importorskip("torch")
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(2)

import repro_torch.models.layers as layers  # noqa: E402
import repro_torch.serving.engine as engine_mod  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.request import Request  # noqa: E402
from repro_torch.models.layers import MeshInfo  # noqa: E402
from repro_torch.serving.decode_graph import (DecodeGraphs,  # noqa: E402
                                              graphs_apply)
from repro_torch.serving.engine import EngineConfig, ServingEngine  # noqa: E402

TINY = dict(num_layers=3, d_model=128, num_heads=4, num_kv_heads=2,
            head_dim=32, d_ff=256, vocab_size=300)
# qkv bias (qwen2-72b), a ring of 8 rows that the requests overrun
# (llama3-8b-sw), qk-norm (qwen3-4b), M-RoPE (qwen2-vl-2b)
CONFIGS = {"qwen2-72b": {}, "llama3-8b-sw": {"sliding_window": 8},
           "qwen3-4b": {}, "qwen2-vl-2b": {}}
GRAPHED = ["qwen2-72b", "llama3-8b", "llama3-8b-sw", "qwen3-4b",
           "chatglm3-6b", "qwen2-vl-2b", "qwen1.5-32b", "llama-30b",
           "codellama2-34b"]
EAGER = ["phi3.5-moe-42b-a6.6b", "llama4-scout-17b-a16e", "rwkv6-3b",
         "recurrentgemma-2b"]
B, S = 3, 64


def tiny(arch):
    return dataclasses.replace(get_config(arch), **TINY, **CONFIGS[arch])


def engine(cfg, graphed, seed=0, params=None, max_batch=B, max_seq_len=S,
           device="cpu", **econf):
    """An engine whose decode goes through the pieces if ``graphed``, else
    through ``forward``."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(engine_mod, "graphs_apply", lambda cfg, device: graphed)
        return ServingEngine(cfg, params=params, seed=seed,
                             econf=EngineConfig(max_batch=max_batch,
                                                max_seq_len=max_seq_len,
                                                eos_token=-1, device=device,
                                                **econf))


def requests(cfg, n=9, seed=5, prompts=(3, 13), outputs=(3, 12)):
    rng = random.Random(seed)
    return [Request(rid=i, arrival_time=0.0, prompt_len=p, output_len=o,
                    prompt_tokens=[rng.randrange(2, cfg.vocab_size)
                                   for _ in range(p)])
            for i, (p, o) in enumerate((rng.randrange(*prompts),
                                        rng.randrange(*outputs))
                                       for _ in range(n))]


def churn_step(eng, pending, step, releases):
    """Prefill from ``pending`` into every free slot, release the request
    in slot ``releases[step]``, then one decode step: its {slot: token}."""
    while eng.free_slots() and pending:
        eng.prefill(pending.pop(0))
    slot = releases.get(step)
    if slot is not None and eng.slot_req[slot] is not None:
        eng.release(eng.slot_req[slot])
    return eng.decode_step()


def churn(eng, reqs, steps=16):
    """Prefill into every free slot before each step, release the request
    in slot 1 at step 5: the step's {slot: token} each step."""
    pending = list(reqs)
    out = [churn_step(eng, pending, step, {5: 1}) for step in range(steps)]
    assert not pending, "the churn served every request"
    return out


def churn_logits(eng, reqs):
    """``churn``, and each decode step's logits: of ``forward`` called
    with a cache, or of ``DecodeGraphs.step``."""
    seen = []
    fwd, step = engine_mod.forward, DecodeGraphs.step

    def forward(*args, **kw):
        logits, cache = fwd(*args, **kw)
        if kw.get("cache") is not None:
            seen.append(logits.clone())
        return logits, cache

    def graph_step(runner, *args):
        logits, new = step(runner, *args)
        seen.append(logits.clone())
        return logits, new
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(engine_mod, "forward", forward)
        mp.setattr(DecodeGraphs, "step", graph_step)
        return churn(eng, reqs), seen


@pytest.mark.parametrize("arch", list(CONFIGS))
def test_pieces_equal_forward_decode_bit_for_bit(arch):
    cfg = tiny(arch)
    eager, pieces = engine(cfg, False), engine(cfg, True)
    assert eager._graphed is False and pieces._graphed is True
    (tok_e, log_e), (tok_p, log_p) = (churn_logits(eager, requests(cfg)),
                                      churn_logits(pieces, requests(cfg)))
    assert tok_p == tok_e
    assert len(log_e) == len(log_p) == 16
    for a, b in zip(log_e, log_p):
        assert torch.equal(a, b)
    for key in eager.cache:
        assert torch.equal(eager.cache[key], pieces.cache[key])
    assert torch.equal(eager.tokens, pieces.tokens)
    assert isinstance(pieces._graphs, DecodeGraphs)
    # the CPU runs the pieces eagerly: nothing captured, nothing replayed
    for eng in (eager, pieces):
        assert eng.graph_captures == eng.graph_steps == 0


@pytest.mark.parametrize("graphed", [False, True])
def test_kernel_called_once_a_layer_through_the_module_name(graphed,
                                                            monkeypatch):
    cfg = tiny("qwen2-72b")
    eng = engine(cfg, graphed)
    real = layers.decode_attention_op
    calls = []

    def counting(*args, **kw):
        calls.append((len(args), tuple(sorted(kw))))
        return real(*args, **kw)
    monkeypatch.setattr(layers, "decode_attention_op", counting)
    tokens_before = eng.tokens
    for r in requests(cfg, n=B):
        eng.prefill(r)
    for step in range(4):
        n0 = len(calls)
        eng.decode_step()
        assert len(calls) - n0 == cfg.num_layers
    assert set(calls) == {(4, ())}
    assert eng.tokens is tokens_before           # written in place only


@pytest.mark.parametrize("arch", GRAPHED + EAGER)
def test_graphs_engage_on_cuda_for_dense_attention_only(arch):
    cfg = get_config(arch)
    assert graphs_apply(cfg, "cuda") is (arch in GRAPHED)
    assert graphs_apply(cfg, torch.device("cuda", 0)) is (arch in GRAPHED)
    assert graphs_apply(cfg, "cpu") is False
    assert graphs_apply(cfg, "cuda", MeshInfo(mesh=object())) is False


def test_cpu_engines_keep_the_eager_step():
    cfg = tiny("qwen2-72b")
    eng = ServingEngine(cfg, econf=EngineConfig(max_batch=B, max_seq_len=S,
                                                eos_token=-1, device="cpu"))
    for r in requests(cfg, n=B):
        eng.prefill(r)
    eng.decode_step()
    assert eng._graphed is False and eng._graphs is None
    assert eng.graph_captures == eng.graph_steps == 0


@pytest.mark.parametrize("attr", ["params", "cache"])
def test_replacing_params_or_cache_drops_the_pieces(attr):
    cfg = tiny("qwen2-72b")
    eng, other = engine(cfg, True), engine(cfg, False, seed=1)
    for r in requests(cfg, n=B):
        eng.prefill(r)
    eng.decode_step()
    runner = weakref.ref(eng._graphs)
    old = getattr(eng, attr)
    leaf = weakref.ref(old["embed"] if attr == "params" else old["k"])
    del old
    setattr(eng, attr, getattr(other, attr))
    assert eng._graphs is None
    gc.collect()
    assert runner() is None and leaf() is None
    eng.decode_step()                   # the next step builds them anew
    assert eng._graphs is not None and runner() is None
    assert eng._graphs.params is eng.params
    assert eng._graphs.blocks[0][2]["k"].data_ptr() == \
        eng.cache["k"][0].data_ptr()


# --------------------------------------------------------------------- #
# on the card: captured graphs against the eager step
# --------------------------------------------------------------------- #
# each model's own widths at 3 layers (pieces 0, 1-2 and 3), bf16; the
# sliding window cut to 256 rows so that the prompts overrun the ring
CARD = {"qwen2-72b": {}, "llama3-8b-sw": {"sliding_window": 256}}
CARD_SLOTS, CARD_STEPS = 16, 72


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the decode graphs are captured "
                    "only on the card")


@pytest.mark.usefixtures("card")
@pytest.mark.parametrize("arch", list(CARD))
def test_graphs_equal_the_eager_step_on_the_card(arch):
    """A graphed and an eager engine on the same weights, in lockstep
    through 72 steps of churn (prefills into freed slots, a release every
    9 steps); then both take a second set of weights, the first is freed
    and its memory refilled with NaN, and 72 more steps.  Every step's
    tokens equal and its logits bit-equal; one capture per set of weights,
    every other step replayed."""
    from repro_torch.models import init_params
    from repro_torch.params import tree_leaves

    cfg = dataclasses.replace(get_config(arch), num_layers=3, **CARD[arch])
    econf = dict(max_batch=CARD_SLOTS, max_seq_len=2048, device="cuda",
                 dtype=torch.bfloat16)
    graph = engine(cfg, True, seed=11, **econf)
    eager = engine(cfg, False, params=graph.params, **econf)
    assert graph._graphed and not eager._graphed
    traffic = dict(n=12 * CARD_SLOTS, seed=12, prompts=(64, 1025),
                   outputs=(2, 40))
    pending = {graph: requests(cfg, **traffic),
               eager: requests(cfg, **traffic)}
    releases = {s: (s // 9) % CARD_SLOTS for s in range(4, 2 * CARD_STEPS, 9)}
    seen = {}
    fwd, graph_step = engine_mod.forward, DecodeGraphs.step

    def forward(*args, **kw):
        logits, cache = fwd(*args, **kw)
        if kw.get("cache") is not None:
            seen[eager] = logits.clone()
        return logits, cache

    def step(runner, *args):
        logits, new = graph_step(runner, *args)
        seen[graph] = logits.clone()
        return logits, new
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(engine_mod, "forward", forward)
        mp.setattr(DecodeGraphs, "step", step)
        for step_no in range(2 * CARD_STEPS):
            if step_no == CARD_STEPS:
                gen = torch.Generator(device="cuda").manual_seed(13)
                second = init_params(cfg, gen, torch.bfloat16, "cuda")
                old = [(t.shape, t.dtype) for t in tree_leaves(graph.params)]
                graph.params = eager.params = second
                assert graph._graphs is None
                del second
                refill = [torch.full(shape, float("nan"), dtype=dtype,
                                     device="cuda") for shape, dtype in old]
            outs = {eng: churn_step(eng, pending[eng], step_no, releases)
                    for eng in (graph, eager)}
            assert outs[graph] == outs[eager], step_no
            assert outs[graph], "every step decodes some slot"
            assert torch.equal(seen.pop(graph), seen.pop(eager)), step_no
    del refill
    assert len(pending[graph]) < traffic["n"] - 3 * CARD_SLOTS
    assert graph.graph_captures == 2
    assert graph.graph_steps == 2 * CARD_STEPS - 2
    assert eager.graph_captures == eager.graph_steps == 0
    for key in graph.cache:
        assert torch.equal(graph.cache[key], eager.cache[key])
    assert torch.equal(graph.tokens, eager.tokens)
