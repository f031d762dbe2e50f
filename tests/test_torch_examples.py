"""The port's examples on the CPU against the JAX package's:
``examples/quickstart_torch.py`` prints the same architecture list,
parameter counts and shapes as ``examples/quickstart.py`` and says that
the kernel's plain version ran; ``examples/train_small_torch.py``'s first
5 losses equal the JAX ``train``'s on the same corpus batches from the
same (bridged) initial weights, at ``tests/test_torch_train.py``'s
limit."""
import dataclasses
import importlib.util
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL = 1e-5          # tests/test_torch_train.py
STEPS = 5


def _run(*args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, *args], capture_output=True,
                         text=True, timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.splitlines()


@pytest.mark.parametrize("arch", ["llama3-8b", "rwkv6-3b"])
def test_quickstart_prints_what_the_jax_example_prints(arch):
    want = _run("examples/quickstart.py", "--arch", arch)
    got = _run("examples/quickstart_torch.py", "--arch", arch, "--device",
               "cpu")
    # every line but the kernel's: architectures, the full config and its
    # parameter count, the reduced one's, the forward and decode shapes
    assert got[:-1] == want[:-1]
    assert "plain version ran" in got[-1] and "no kernel" in got[-1]


def test_train_small_first_losses_match_the_jax_train(monkeypatch):
    import jax
    import numpy as np

    from repro.configs import get_smoke_config
    from repro.data.pipeline import ByteTokenizer, TokenDataset, \
        synthetic_corpus
    from repro.models import init_params
    from repro.training.optimizer import AdamW
    from repro.training.train_loop import train
    from repro_torch.params import params_from_jax
    from repro_torch.training import train_loop

    spec = importlib.util.spec_from_file_location(
        "train_small_torch", os.path.join(ROOT, "examples",
                                          "train_small_torch.py"))
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)

    tcfg = ex.config()
    cfg = dataclasses.replace(get_smoke_config("llama3-8b"),
                              **{f.name: getattr(tcfg, f.name)
                                 for f in dataclasses.fields(tcfg)})
    ds = TokenDataset.from_texts(synthetic_corpus(1024),
                                 ByteTokenizer(cfg.vocab_size))
    _, want = train(cfg, ds.batches(8, 128), steps=STEPS,
                    optimizer=AdamW(lr=6e-4), log_fn=lambda s: None)

    tree = jax.tree.map(np.asarray, init_params(jax.random.key(0), cfg))
    monkeypatch.setattr(train_loop, "init_params",
                        lambda c, g, dt, dev: params_from_jax(tree, c, dev))
    got = ex.run(STEPS, device="cpu", log_every=STEPS)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
