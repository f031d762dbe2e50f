"""The dense decoder family: Qwen2, ChatGLM3, Llama and their kind, the
family of a configuration file that names none.

Every layer is full causal attention over grouped key/value heads, with
optional q/k/v biases and a rotary over the leading ``rope_dims`` of each
head, and a SwiGLU; untied embedding and head.  The harness's functions
are bound here unchanged: ``harness/model.py``'s ``Model``,
``harness/weights.py``'s draw and layout, ``harness/reference.py``'s float32
reference and its float8 control, ``harness/work.py``'s model FLOPs.  What
this file adds is the check on the port's configuration and the source's
key names.  Nothing here imports the program.

A family module gives (``harness.model.FAMILY``):
  ``Model``             built from the file's ``model`` block; ``layers``
                        and ``vocab`` are every family's;
  ``SOURCE_KEYS``       each ``Model`` field's key in the source's
                        ``config.json`` (the file's top level);
  ``draw(m, seed, dtype, device)``   the weights from the seed;
  ``port_params(w, m)`` the weights as the port's ``params``;
  ``port_fields(m)``    the port's ``ModelConfig`` fields, by name, that
                        have to equal these values;
  ``logits_at(w, m, seqs, rows, control=False)``   the plain reference;
  ``prefill_flops(m, T)``, ``decode_flops(m, batch, ctx_sum)``.
"""
from ecobench.harness.model import Model
from ecobench.harness.reference import logits_at
from ecobench.harness.weights import draw, layout, port_params
from ecobench.harness.work import decode_flops, prefill_flops

__all__ = ["Model", "SOURCE_KEYS", "draw", "layout", "port_params",
           "port_fields", "logits_at", "prefill_flops", "decode_flops"]

SOURCE_KEYS = dict(layers="num_hidden_layers", d_model="hidden_size",
                   heads="num_attention_heads",
                   kv_heads="num_key_value_heads",
                   d_ff="intermediate_size", vocab="vocab_size",
                   rope_theta="rope_theta", norm_eps="rms_norm_eps")


def port_fields(m: Model) -> dict:
    """The port's configuration, field by field, for a dense model: every
    block global attention (``"attn"``), no experts, no window."""
    return {"d_model": m.d_model, "num_heads": m.heads,
            "num_kv_heads": m.kv_heads, "head_dim": m.head_dim,
            "d_ff": m.d_ff, "vocab_size": m.vocab, "qkv_bias": m.qkv_bias,
            "rope": "half" if m.rope_dims * 2 == m.head_dim else "full",
            "rope_theta": m.rope_theta, "norm_eps": m.norm_eps,
            "block_pattern": ("attn",), "num_experts": 0, "qk_norm": False,
            "tie_embeddings": False, "logit_soft_cap": 0.0,
            "is_encoder": False, "sliding_window": 0}
