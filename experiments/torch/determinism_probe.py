"""Which backward operations of the training step vary between two runs
on one GPU, with torch's deterministic algorithms off and on.

    python3 experiments/torch/determinism_probe.py   # from the repo root

Each case runs twice on the same inputs and lists the outputs that differ
bit for bit: scaled_dot_product_attention's backward at phase 9's shape
(1 x 32 heads x 2048 x 64, bf16, causal) under each backend and the
default choice (indices 0, 1, 2 = dq, dk, dv), the embedding's gradient
with repeated tokens, the loss's gold gather, and the gradient leaves of
TinyLlama-1.1B's loss at 2 and 22 layers on 1 x 2048 tokens.  Prints the
results, all of them as one JSON object on the last line.
"""
import dataclasses, json, os, subprocess, sys
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))
import torch
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel
from repro_torch.kernels import ops
from repro_torch.configs import ARCHS
from repro_torch.shardings import Sharding
from repro_torch.train import SyntheticLM, init_train_state, shard_batch
from repro_torch.train.step import value_and_grad
from repro_torch.ckpt.store import _leaf_paths
from repro_torch.models import model as M

print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
dev = torch.device("cuda"); ops.set_device(dev)
res = {}
def twice(fn):
    a, b = fn(), fn()
    return [i for i, (x, y) in enumerate(zip(a, b)) if not torch.equal(x, y)]
g = torch.Generator(device=dev).manual_seed(0)
for det in (False, True):
    torch.use_deterministic_algorithms(det)
    # SDPA backward at phase 9's shape, each backend
    q, k, v = (torch.randn((1, 32, 2048, 64), generator=g, device=dev).to(torch.bfloat16).requires_grad_() for _ in range(3))
    do = torch.randn((1, 32, 2048, 64), generator=g, device=dev).to(torch.bfloat16)
    for name, be in (("flash", SDPBackend.FLASH_ATTENTION), ("efficient", SDPBackend.EFFICIENT_ATTENTION), ("math", SDPBackend.MATH)):
        def run():
            with sdpa_kernel(be):
                o = F.scaled_dot_product_attention(q, k, v, is_causal=True)
            return torch.autograd.grad(o, (q, k, v), do)
        try:
            res[f"sdpa_{name}_det{int(det)}"] = twice(run)
        except Exception as e:
            res[f"sdpa_{name}_det{int(det)}"] = repr(e)[:200]
    # default backend choice
    def run_default():
        o = F.scaled_dot_product_attention(q, k, v, is_causal=True)
        return torch.autograd.grad(o, (q, k, v), do)
    res[f"sdpa_default_det{int(det)}"] = twice(run_default)
    # the embedding's gradient (index with repeated tokens)
    E = (torch.randn((32000, 2048), generator=g, device=dev) * 0.02).to(torch.bfloat16).requires_grad_()
    tok = torch.randint(0, 32000, (1, 2048), generator=g, device=dev, dtype=torch.int32)
    tok[0, ::4] = 7   # repeated rows
    dx = torch.randn((1, 2048, 2048), generator=g, device=dev).to(torch.bfloat16)
    res[f"embed_det{int(det)}"] = twice(lambda: torch.autograd.grad(E[tok], (E,), dx))
    # the loss's gold gather
    logits = torch.randn((1, 512, 32000), generator=g, device=dev).to(torch.bfloat16).requires_grad_()
    lab = torch.randint(0, 32000, (1, 512, 1), generator=g, device=dev)
    res[f"gather_det{int(det)}"] = twice(lambda: torch.autograd.grad(logits.gather(-1, lab).float().sum(), (logits,)))
    # the whole step's grads at 2 layers and at 22 layers, 1 x 2048
    for L in (2, 22):
        cfg = dataclasses.replace(ARCHS["tinyllama-1.1b"], n_layers=L)
        params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(1), shards=4, device=dev)
        b = shard_batch(SyntheticLM(cfg.vocab, 2048, 1, seed=5).batch_at(0))
        def grads():
            return [x for _, x in _leaf_paths(value_and_grad(params, b, cfg, Sharding(None, cfg))[2])]
        names = [n for n, _ in _leaf_paths(params)]
        res[f"step_L{L}_det{int(det)}"] = [names[i] for i in twice(grads)]
        del params
        torch.cuda.empty_cache()
    print(det, json.dumps(res), flush=True)
torch.use_deterministic_algorithms(False)
print(json.dumps(res))
