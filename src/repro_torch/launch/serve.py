"""Serving launcher of the port: a batch of prompts is prefilled in one pass
(attention through the flash-attention kernel, the SSD scan through the SSD
kernel), then decoded greedily from the KV and SSM caches. Counterpart of
``repro/launch/serve.py`` and ``examples/serve_batch.py``. ``--arch`` takes
llama3.2-1b, chatglm3-6b, internlm2-20b, h2o-danube-3-4b (dense),
granite-moe-1b-a400m, granite-moe-3b-a800m (moe), mamba2-370m (ssm),
zamba2-7b (hybrid), whisper-medium (encdec: the prompt decodes over seeded
stub audio frames) and llava-next-34b (vlm: seeded stub image patches ahead
of the prompt, ``data.pipeline.stub_inputs``). The reference prefills by
stepping the decoder over the prompt; this one-pass prefill routes a moe
model's prompt in groups of up to 1024 tokens, so it equals that stepping
only where no expert's capacity drops a choice (``LM.prefill``). ``main``
builds the model as the reference's does: the launch group
(``launch.mesh.launch_group``), the mesh (1, n) over its n ranks,
``ShardingPolicy``, ``pad_heads`` and ``LM(policy=)``; at one rank it serves
the same tokens and logits as ``LM`` without a policy, bit for bit.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
        --batch 4 --prompt-len 1024 --new-tokens 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-moe-1b-a400m \\
        --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \\
        --prompt-len 32 --new-tokens 8
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-medium \\
        --prompt-len 416

``--dry-run`` runs the production decode cell (``--arch``, ``--shape``
decode_32k or long_500k, ``--mesh``) through the port's dry run in a child
process (``launch/dryrun.py:in_child``), as the reference's does; ``--shape``
and ``--mesh`` are read only there.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-20b --dry-run

Times are host-clock spans that end in a device synchronise; the first call
in a process includes the kernel build (or load) and library start-up.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import stub_inputs
from repro_torch.launch.mesh import launch_group
from repro_torch.launch.sharding import ShardingPolicy, pad_heads
from repro_torch.models import LM


def make_prompts(batch: int, prompt_len: int, vocab: int, seed: int) -> np.ndarray:
    """Seeded random prompts [batch, prompt_len] of token ids."""
    return np.random.default_rng(seed).integers(0, vocab, (batch, prompt_len))


def prefix_len(stub: dict) -> int:
    """Positions ahead of the prompt: the vlm's ``patches``, none otherwise."""
    return stub["patches"].shape[1] if "patches" in stub else 0


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def serve(lm: LM, params, prompts: torch.Tensor, new_tokens: int, **stub) -> dict:
    """Prefill ``prompts`` [B, S] (behind the vlm's ``patches``, over the
    encdec's ``frames``: the family's stub input as a keyword), then
    ``new_tokens`` greedy decode steps from position P + S (P patches, 0
    without). Returns the B x (new_tokens + 1) generated tokens (the first
    from the prefill logits), the prefill and last logits, and the two
    spans."""
    B, S = prompts.shape
    start = S + prefix_len(stub)
    dev = lm.device
    synchronize(dev)
    t0 = time.perf_counter()
    prefill_logits, cache = lm.prefill(params, prompts, max_seq=start + new_tokens, **stub)
    tok = prefill_logits.argmax(-1)
    synchronize(dev)
    t1 = time.perf_counter()
    generated, logits = [tok], prefill_logits
    for i in range(new_tokens):
        logits, cache = lm.decode_step(params, cache, tok, start + i)
        tok = logits.argmax(-1)
        generated.append(tok)
    synchronize(dev)
    t2 = time.perf_counter()
    return {"tokens": torch.stack(generated, dim=1),
            "prefill_logits": prefill_logits, "last_logits": logits,
            "prefill_s": t1 - t0, "decode_s": t2 - t1,
            "batch": B, "prompt_len": S, "prefix_len": start - S, "new_tokens": new_tokens}


def report(out: dict) -> str:
    B, S, n = out["batch"], out["prompt_len"], out["new_tokens"]
    dec = out["decode_s"]
    after = f" after {out['prefix_len']} patches" if out.get("prefix_len") else ""
    return (f"prefill: {B}x{S} tokens{after} in {out['prefill_s'] * 1e3:.2f} ms\n"
            f"decode: {n} steps x {B} seqs in {dec * 1e3:.2f} ms "
            f"({dec * 1e3 / max(n, 1):.3f} ms/step, "
            f"{B * n / dec if dec > 0 else 0.0:,.1f} tok/s)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=1024)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--reduced", action="store_true",
                    help="the small same-family config (CPU smoke runs)")
    ap.add_argument("--device", default=None,
                    help="'cuda' (default; raises without a card) or 'cpu'")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--shape", default="decode_32k", choices=["decode_32k", "long_500k"],
                    help="the production cell of --dry-run")
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod"],
                    help="the production mesh of --dry-run")
    ap.add_argument("--dry-run", action="store_true",
                    help="run the full decode cell on fake tensors (launch/dryrun.py)")
    args = ap.parse_args(argv)
    if args.dry_run:
        from repro_torch.launch.dryrun import in_child

        return in_child(args.arch, args.shape, args.mesh, args.device)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    with launch_group(args.device) as (mesh, device):
        policy = ShardingPolicy(mesh, cfg)
        cfg = pad_heads(cfg, policy.tp_size)
        policy.cfg = cfg
        lm = LM(cfg, ep_degree=policy.tp_size, device=device, policy=policy)
        params = lm.init(args.seed)
        where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
        print(f"serving {cfg.name}: {cfg.param_count() / 1e6:.1f}M params, "
              f"{cfg.dtype}, batch={args.batch} on {where}, mesh={mesh.axis_sizes}")
        prompts = torch.from_numpy(make_prompts(
            args.batch, args.prompt_len, cfg.vocab_size, args.seed)).to(device)
        stub = {name: torch.from_numpy(x).to(device)
                for name, x in stub_inputs(cfg, args.batch, args.seed).items()}
        out = serve(lm, params, prompts, args.new_tokens, **stub)
        print(report(out))
        tokens = out["tokens"]
        tokens = tokens.full_tensor() if hasattr(tokens, "full_tensor") else tokens
        for b in range(min(args.batch, 2)):
            print(f"  seq {b}: {tokens[b, :10].tolist()} ...")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
