"""The port's serving launcher (repro_torch.launch.serve) on the CPU: the
command line for five families, greedy tokens equal to the JAX
reference's prefill + decode on carried float32 weights, and decode
positions outside the cache as typed errors."""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as RM
from repro.shardings import Sharding as RSharding
from repro_torch.errors import ConfigError
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import model as M
from repro_torch.shardings import Sharding
from torch_model_parity import carried
from torch_model_parity import torch_one_thread  # noqa: F401 (autouse)

LINE = re.compile(r"^(\S+): prefill\((\d+)x(\d+)\) [\d.]+s; decode (\d+) "
                  r"tokens [\d.]+s \([\d.]+ tok/s\); sample: \[[\d, ]+\]$")


@pytest.fixture(autouse=True)
def _cpu():
    prev = ops.device()
    ops.set_device("cpu")
    try:
        yield
    finally:
        ops.set_device(prev)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "deepseek-moe-16b",
                                  "zamba2-2.7b", "xlstm-125m",
                                  "internvl2-2b"])
def test_serve_command_line_on_the_cpu(arch, capsys):
    """--gen 4 with a 16-token prompt: the reference's launcher raises for
    the VLM here (its cache has S + gen rows for n_patches + S prompt
    positions); the port sizes the cache n_patches + S + gen."""
    serve.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                "--prompt-len", "16", "--gen", "4"])
    out = capsys.readouterr().out.strip().splitlines()
    m = LINE.match(out[-1])
    assert m, out
    assert m.groups() == (arch, "2", "16", "4")


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "deepseek-moe-16b",
                                  "zamba2-2.7b", "xlstm-125m",
                                  "internvl2-2b"])
def test_greedy_tokens_equal_the_reference(arch):
    sc, tc, p, tp = carried(arch)
    B, S, gen = 2, 16, 6
    rng = torch.Generator().manual_seed(5)
    batch = serve.make_batch(tc, B, S, rng, "cpu")
    if tc.frontend == "vision":
        batch["patch_embeds"] = batch["patch_embeds"].float()
    with torch.no_grad():
        got = serve.generate(tp, batch, tc, Sharding(None, tc), gen)
    shd = RSharding(None, sc)
    jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    pos0 = S + (sc.n_patches if sc.frontend == "vision" else 0)
    cache, logits = RM.prefill(p, jb, sc, shd, cache_len=pos0 + gen)
    step = jax.jit(lambda p, c, b: RM.decode_step(p, c, b, sc, shd))
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    want = [tok]
    for i in range(gen - 1):
        cache, logits = step(p, cache, {
            "tokens": tok, "pos": jnp.full((B,), pos0 + i, jnp.int32)})
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        want.append(tok)
    want = np.concatenate([np.asarray(t) for t in want], axis=1)
    assert np.array_equal(got["tokens"].numpy(), want)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "zamba2-2.7b"])
def test_decode_outside_the_cache_raises(arch):
    """The reference's dynamic_update_slice clamps a row past the cache's
    end onto its last row; the port raises ConfigError instead."""
    _, tc, _, tp = carried(arch)
    shd = Sharding(None, tc)
    cache = M.init_cache(tc, 2, 8, dtype=torch.float32)
    tok = torch.zeros((2, 1), dtype=torch.int32)
    for bad in ([8, 0], [0, -1]):
        with pytest.raises(ConfigError):
            M.decode_step(tp, cache, {"tokens": tok,
                                      "pos": torch.tensor(bad)}, tc, shd)
    with torch.no_grad():
        M.decode_step(tp, cache, {"tokens": tok, "pos": torch.tensor([7, 0])},
                      tc, shd)
    with pytest.raises(ConfigError):
        M.prefill(tp, {"tokens": torch.zeros((2, 9), dtype=torch.int32)},
                  tc, shd, cache_len=8)
