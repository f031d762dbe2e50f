"""The plain reference against the port's CPU path at a tiny size: a
prefill, then decode steps through the slotted cache, on the benchmark's
own weights; and the float8 control departs from both."""
import copy

import pytest
import torch

from ecobench_testlib import TINY
from ecobench.harness import reference, serve
from ecobench.harness.model import load_config, model_of
from ecobench.harness.weights import draw, port_params


def _tiny(name, group, half=None):
    """The configuration at a tiny size; ``half`` turns the rotary over
    half of each head (ChatGLM's layout) or the whole of it."""
    conf = copy.deepcopy(load_config(name))
    m = conf["model"]
    if half is None:
        half = m["rope_dims"] * 2 == m["head_dim"]
    m.update(TINY, heads=2 * group, kv_heads=2,
             rope_dims=TINY["head_dim"] // (2 if half else 1))
    conf["port_overrides"] = dict(
        d_model=m["d_model"], num_heads=m["heads"],
        num_kv_heads=m["kv_heads"], head_dim=m["head_dim"], d_ff=m["d_ff"],
        vocab_size=m["vocab"], rope="half" if half else "full")
    return conf, model_of(conf)


@pytest.mark.parametrize("name,group,half", [("qwen2-72b", 8, False),
                                             ("qwen2-72b", 16, True)])
def test_prefill_then_decode_through_the_cache(name, group, half):
    from repro_torch.models import forward, init_cache, write_slot
    conf, m = _tiny(name, group, half)
    cfg = serve.port_config(conf, m)
    w = draw(m, 1234, torch.float32, "cpu")
    params = port_params(w, m)
    g = torch.Generator().manual_seed(7)
    seq = torch.randint(3, m.vocab, (40,), generator=g).tolist()
    T, n_dec = 31, 9
    with torch.no_grad():
        logits, pc = forward(params, cfg, {"tokens": torch.tensor([seq[:T]])},
                             return_cache=True)
        cache = init_cache(cfg, 2, 64, torch.float32, "cpu")
        write_slot(cache, pc, 1, T)
        got = [logits[0, -1]]
        lengths = torch.tensor([0, T])
        for i in range(n_dec):
            tok = torch.tensor([[0], [seq[T + i]]])
            lg, cache = forward(params, cfg, {"tokens": tok}, cache=cache,
                                cache_len=lengths)
            got.append(lg[1, 0])
            lengths = lengths + torch.tensor([0, 1])
        ref = reference.logits_at(w, m, [seq[:T + n_dec]],
                                  [range(T - 1, T + n_dec)])[0]
    got = torch.stack(got)
    scale = ref.abs().max()
    assert torch.allclose(got, ref, atol=2e-5 * scale, rtol=0)
    # the whole prefill's rows too
    ref_all = reference.logits_at(w, m, [seq[:T]], [range(T)])[0]
    assert torch.allclose(logits[0], ref_all, atol=2e-5 * scale, rtol=0)


def test_control_departs():
    conf, m = _tiny("qwen2-72b", 8)
    w = draw(m, 99, torch.float32, "cpu")
    seq = list(range(5, 45))
    ref = reference.logits_at(w, m, [seq], [range(40)])[0]
    low = reference.logits_at(w, m, [seq], [range(40)], control=True)[0]
    rel = (low - ref).abs().max() / ref.abs().max()
    assert 1e-3 < rel < 0.5


def test_fp8_rounding():
    x = torch.tensor([[1.0, 0.0, -448.0, 3.3]])
    y = reference.fp8(x, -1)
    assert y[0, 2] == -448.0 and y[0, 1] == 0.0
    assert abs(float(y[0, 3]) - 3.3) / 3.3 < 2 ** -4
