"""Batched serving: prefill a batch of prompts by stepping the
decoder over them, then decode greedily from the cache. The port of
``examples/serve_batch.py``.

    PYTHONPATH=src python -m repro_torch.examples.serve_batch --device cpu \\
        --batch 4 --new-tokens 16
    PYTHONPATH=src python -m repro_torch.examples.serve_batch    # on the card

It computes the reference's function: the reduced config of ``--arch`` in
f32, an f32 cache from ``decode_init``, ``decode_step`` over the prompt one
position at a time, then ``--new-tokens`` greedy tokens, the first from the
last prompt step's logits and the others from ``new_tokens - 1`` decode
steps. ``launch/serve.py`` prefills in one pass instead; in the moe family
that is another function, since a decode step routes its B tokens as one
group with a capacity of its own (``LM.prefill``), and this stepping is how
the reference serves that family.

Weights come from ``LM.init(WEIGHT_SEED)`` and prompts from
``make_prompts(..., PROMPT_SEED)``: the numbers of the reference's
``PRNGKey``s, not its bits (torch does not draw ``jax.random``'s).
Times are host-clock spans that end in a device synchronise; the first
call in a process includes library start-up.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.launch.serve import make_prompts, synchronize
from repro_torch.models import LM

WEIGHT_SEED = 0
PROMPT_SEED = 7


@torch.inference_mode()
def serve_stepped(lm: LM, params, prompts: torch.Tensor, new_tokens: int) -> dict:
    """Step ``decode_step`` over ``prompts`` [B, S] from an f32 cache of S +
    ``new_tokens`` positions, then decode greedily over positions S ..
    S + new_tokens - 2. Returns the B x new_tokens generated tokens, every
    step's f32 logits [B, S + new_tokens - 1, vocab] (step t's at index t),
    and the spans of the prompt's steps and of the decode steps."""
    B, S = prompts.shape
    max_seq = S + new_tokens
    dev = lm.device
    cache = lm.decode_init(B, max_seq, dtype=torch.float32)
    steps = []
    synchronize(dev)
    t0 = time.perf_counter()
    # prefill by stepping the decoder over the prompt (cache fills as we go)
    logits = None
    for t in range(S):
        logits, cache = lm.decode_step(params, cache, prompts[:, t], t)
        steps.append(logits)
    synchronize(dev)
    t1 = time.perf_counter()
    # greedy decode
    tokens = logits.argmax(-1)
    generated = [tokens]
    for t in range(S, max_seq - 1):
        logits, cache = lm.decode_step(params, cache, tokens, t)
        steps.append(logits)
        tokens = logits.argmax(-1)
        generated.append(tokens)
    synchronize(dev)
    t2 = time.perf_counter()
    return {"tokens": torch.stack(generated, dim=1), "logits": torch.stack(steps, dim=1),
            "prefill_s": t1 - t0, "decode_s": t2 - t1}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="'cuda' (default; raises without a card) or 'cpu'")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch).reduced(dtype="float32")
    lm = LM(cfg, device=device)
    params = lm.init(WEIGHT_SEED)
    print(f"serving reduced {args.arch}: {cfg.param_count()/1e6:.1f}M params")

    prompts = torch.from_numpy(make_prompts(
        args.batch, args.prompt_len, cfg.vocab_size, PROMPT_SEED)).to(device)
    out = serve_stepped(lm, params, prompts, args.new_tokens)
    print(f"prefill: {args.prompt_len} steps x {args.batch} seqs "
          f"in {out['prefill_s']:.2f}s")
    tokens, dt = out["tokens"], out["decode_s"]
    total = args.batch * tokens.shape[1]
    print(f"decode: {tokens.shape[1]} tokens x {args.batch} seqs in {dt:.2f}s "
          f"({total/dt:,.0f} tok/s)")
    for b in range(min(args.batch, 2)):
        print(f"  seq {b}: {tokens[b, :10].tolist()} ...")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
