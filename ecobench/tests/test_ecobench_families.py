"""The dense family and the kernel files held to the arithmetic they
replaced: the weights' draw by digests of the flat buffer taken before the
family existed, the reference and its control bit-equal to
``harness/reference.py``, the work counts against the formulas the harness
used, and each kernel file's ``work`` against the shim methods that
``harness/trace.py`` held before kernel files (copied below)."""
import hashlib

import numpy as np
import pytest
import torch

from ecobench_testlib import REPO  # noqa: F401  (puts the repo on the path)
from ecobench.harness import files, reference, trace, weights, work
from ecobench.harness.model import FAMILY, family_of, load_config, model_of

DENSE = files.module("families", "dense")
TINY = dict(layers=2, d_model=128, heads=8, kv_heads=2, head_dim=32,
            d_ff=256, vocab=256, qkv_bias=True, rope_dims=32,
            rope_theta=1e6, norm_eps=1e-6)
# sha256 of the flat buffer, leaves in layout order, as drawn before the
# family existed (float32 bytes; bfloat16 as int16)
DIGESTS = {
    (torch.float32, 7):
        "2e6f270e43b39f9bdbc267a1c03b4aebf4d80c9284977fdeea10726291ba4d55",
    (torch.float32, 2**31 + 5):
        "3ca0ac9fca4edfdc636d78df936dff8303964fdfa1a29d0d5fe29af083654668",
    (torch.bfloat16, 7):
        "b0f941fc68a1cf38634ae2f41541189b7989b919a1ce69f312d9d550f6ddc1eb",
    (torch.bfloat16, 2**31 + 5):
        "ee564014582b12daf986d4d2f955ebc5bd33bdef8ae1886719ead58b66ed28c4",
}


def _flat(w, m):
    leaves = []
    for name, _, _ in DENSE.layout(m):
        if name.startswith("layers."):
            _, i, leaf = name.split(".")
            leaves.append(w["layers"][int(i)][leaf])
        else:
            leaves.append(w[name])
    return torch.cat([t.reshape(-1) for t in leaves])


def test_a_file_without_family_is_dense():
    conf = load_config("qwen2-72b")
    assert "family" not in conf
    assert family_of(conf) is DENSE
    assert isinstance(model_of(conf), DENSE.Model)
    assert all(hasattr(DENSE, k) for k in FAMILY)


def test_a_family_lacking_a_name_is_refused(tmp_path, monkeypatch):
    (tmp_path / "families").mkdir()
    (tmp_path / "families" / "bare.py").write_text("Model = dict\n")
    monkeypatch.setattr(files, "ROOTS", [tmp_path] + files.ROOTS)
    with pytest.raises(AttributeError, match="draw"):
        family_of({"family": "bare"})


@pytest.mark.parametrize("dtype,seed", sorted(DIGESTS, key=str))
def test_draw_digest(dtype, seed):
    m = DENSE.Model(**TINY)
    flat = _flat(DENSE.draw(m, seed, dtype, "cpu"), m)
    raw = flat.view(torch.int16 if dtype == torch.bfloat16 else torch.uint8)
    assert hashlib.sha256(raw.numpy().tobytes()).hexdigest() == \
        DIGESTS[(dtype, seed)]


@pytest.mark.parametrize("control", [False, True])
def test_logits_at_bit_equal_to_the_harness_reference(control):
    m = DENSE.Model(**TINY)
    w = DENSE.draw(m, 11, torch.bfloat16, "cpu")
    g = torch.Generator().manual_seed(3)
    seqs = [torch.randint(3, m.vocab, (n,), generator=g).tolist()
            for n in (40, 7)]
    rows = [range(30, 40), range(7)]
    got = DENSE.logits_at(w, m, seqs, rows, control=control)
    want = reference.logits_at(w, m, seqs, rows, control=control)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_port_params_are_the_weights_views():
    m = DENSE.Model(**TINY)
    w = DENSE.draw(m, 5, torch.float32, "cpu")
    p = DENSE.port_params(w, m)
    q = weights.port_params(w, m)
    assert p["embed"] is q["embed"] is w["embed"]
    for a, b in zip(p["layers"], q["layers"]):
        for part in ("norm1", "core", "norm2", "ffn"):
            assert a[part].keys() == b[part].keys()
            assert all(a[part][k] is b[part][k] for k in a[part])
    assert p["layers"][1]["core"]["bq"] is w["layers"][1]["bq"]


@pytest.mark.parametrize("name", ["qwen2-72b"])
def test_work_counts_equal_the_harness_formulas(name):
    m = model_of(load_config(name))
    d, hd = m.d_model, m.head_dim
    params = (d * m.heads * hd * 2 + 2 * d * m.kv_heads * hd
              + 3 * d * m.d_ff)
    for T in (1, 2, 17, 1000, 2690, 4096):
        want = (2.0 * params * T * m.layers
                + 4.0 * hd * m.heads * (T * (T + 1) // 2) * m.layers
                + 2.0 * d * m.vocab)
        assert DENSE.prefill_flops(m, T) == want
    for b in (1, 2, 7, 32):
        for ctx in (0, b, 1000 * b, 8191 * b):
            want = (2.0 * params * b * m.layers
                    + 4.0 * hd * m.heads * (ctx + b) * m.layers
                    + 2.0 * d * m.vocab * b)
            assert DENSE.decode_flops(m, b, ctx) == want


# ---- the shim methods that harness/trace.py held before kernel files ---- #
def _old_flash_prefill(q, k, v, **kw):
    if kw.get("window", 0):
        return None
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    return work.flash_prefill_work(B, T, S, Hq, Hkv, D, q.element_size(),
                                   kw.get("q_offset", 0))


def _old_decode_attention(q, k_cache, v_cache, lengths, engine_lengths,
                          max_seq_len):
    valid_rows = int(np.minimum(engine_lengths + 1, max_seq_len).sum())
    B, Hq, D = q.shape
    Hkv = k_cache.shape[2]
    return work.decode_attention_work(B, Hq, Hkv, D, valid_rows,
                                      q.element_size())


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("B,T,off,Hq,Hkv,D,window,dtype", [
    (1, 2690, 0, 64, 8, 128, 0, torch.bfloat16),
    (1, 4096, 0, 64, 8, 128, 0, torch.bfloat16),
    (1, 1, 0, 64, 8, 128, 0, torch.bfloat16),
    (2, 100, 300, 32, 8, 128, 0, torch.float32),
    (1, 1024, 0, 40, 8, 128, 8192, torch.bfloat16),
])
def test_flash_prefill_work_equals_the_old_shim(B, T, off, Hq, Hkv, D,
                                                window, dtype):
    kern = files.module("kernels", "flash_prefill")
    assert kern.ATTR == "flash_prefill_op"
    q = _meta(B, T, Hq, D, dtype=dtype)
    k = v = _meta(B, off + T, Hkv, D, dtype=dtype)
    kw = {"causal": True, "window": window}
    if off:
        kw["q_offset"] = off
    got = kern.work((q, k, v), kw, trace.Step())
    assert got == _old_flash_prefill(q, k, v, **kw)
    assert (got is None) == bool(window)


@pytest.mark.parametrize("B,S,Hq,Hkv,D", [(32, 8192, 64, 8, 128),
                                          (8, 2048, 32, 8, 128),
                                          (1, 8192, 64, 8, 128)])
def test_decode_attention_work_equals_the_old_shim(B, S, Hq, Hkv, D):
    kern = files.module("kernels", "decode_attention")
    assert kern.ATTR == "decode_attention_op"
    rng = np.random.default_rng(B)
    lengths = rng.integers(0, S, B).astype(np.int32)
    lengths[0] = S - 1                    # a full slot: capped at S
    if B > 2:
        lengths[1] = 0                    # a free slot
    q = _meta(B, Hq, D)
    kc = vc = _meta(B, S, Hkv, D)
    valid = _meta(B, dtype=torch.int32)
    step = trace.Step()
    step.begin(lengths)
    lengths += 5                          # the engine moves on: the step
    got = kern.work((q, kc, vc, valid), {}, step)   # keeps its own copy
    assert got == _old_decode_attention(q, kc, vc, valid, lengths - 5, S)
    assert kern.work((q, kc, vc, valid), {}, step) == got


def test_every_kernel_file_names_a_layers_entry():
    import repro_torch.models.layers as layers
    kernels = files.modules("kernels")
    assert {"flash_prefill", "decode_attention"} <= set(kernels)
    for kern in kernels.values():
        assert callable(getattr(layers, kern.ATTR))
        assert callable(kern.work)
