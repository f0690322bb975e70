"""Serving front end: a thin layer over ``repro_torch.serve.LMEngine``, the
port of ``repro/launch/serve.py``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
      --batch 4 --prompt-len 64 --gen 32            # on the card
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --arch smollm-135m --batch 2 --prompt-len 16 --gen 4

The engine owns admission, wave scheduling, prefill/decode interleaving
and the per-call timing log; this module builds synthetic prompts,
submits them, and turns the engine's ``call_log`` into the ``serve.done``
record:

  ``warmup_s``          prefill wall + the first decode call
  ``steady_s``          every later decode call
  ``tok_per_s_steady``  tokens emitted by post-warm-up decode calls / steady_s
  ``tok_per_s``         ALL tokens (batch * gen, the prefill's first token
                        included) over the end-to-end wall
  ``static_state_bytes``  the engines' static decode states
  ``decode_graphs``     each engine's decode graph: warm-up and capture ms
                        and pool bytes (None on the CPU, where nothing is
                        captured)

``--replicas N`` runs N engines on the one device with the lanes split
across them, and aggregates their stats; it does not shard (the
distributed layer is ROADMAP Queue 1 item 14).  The CLI runs the reduced
config of ``--arch`` (the JAX CLI's rule); ``serve()`` takes any config.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs.base import ShapeCell, reduced
from repro_torch.configs.registry import get_arch
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models import lm
from repro_torch.models.ode_nets import resolve_device
from repro_torch.obs import MetricsSink, StructuredLogger
from repro_torch.serve import LMEngine


def _stats_from_log(call_log, tokens_total: int) -> dict:
    """Warm-up / steady-state split of an engine ``call_log``."""
    prefill_s = sum(c["wall_s"] for c in call_log if c["op"] == "prefill")
    decode = [c for c in call_log if c["op"] == "decode"]
    decode_s = sum(c["wall_s"] for c in decode)
    warm = [c for c in decode if c.get("compile")]
    steady = [c for c in decode if not c.get("compile")]
    warmup_s = prefill_s + sum(c["wall_s"] for c in warm)
    steady_s = sum(c["wall_s"] for c in steady)
    steady_tok = sum(c["tokens"] for c in steady)
    total_s = prefill_s + decode_s
    return {
        "prefill_s": prefill_s,
        "decode_s": decode_s,
        "warmup_s": warmup_s,
        "steady_s": steady_s,
        "tokens": tokens_total,
        "tok_per_s": tokens_total / max(total_s, 1e-9),
        "tok_per_s_steady": steady_tok / max(steady_s, 1e-9),
    }


def serve(cfg, *, batch: int, prompt_len: int, gen: int,
          temperature: float = 0.0, seed: int = 0, log_fn=print,
          sink: MetricsSink | None = None, replicas: int = 1,
          decode_slice: int = 8, device="cuda", params=None):
    """Prefill + greedy/temperature decode through the serve engine.
    Returns (tokens ``(batch, gen)`` int32 on the CPU, stats).

    ``params`` (on ``device``) defaults to random weights drawn once from
    ``seed`` on a generator on the device and shared by every replica.
    ``sink`` receives a structured ``serve.done`` record beside the human
    line through ``log_fn``."""
    device = resolve_device(device)
    replicas = max(1, int(replicas))
    if batch % replicas != 0:
        raise ValueError(f"batch {batch} must divide evenly over "
                         f"{replicas} replicas")
    lanes = batch // replicas
    cell = ShapeCell("serve", prompt_len, batch, "prefill")
    prompt = SyntheticLM(cfg, cell, seed=seed).batch(0)["tokens"].numpy()
    if params is None:
        gen_ = torch.Generator(device).manual_seed(seed)
        params = lm.init_params(cfg, gen_, device=device)

    engines = [LMEngine(cfg, lanes=lanes, prompt_len=prompt_len,
                        max_gen=gen, decode_slice=decode_slice,
                        temperature=temperature, seed=seed, params=params,
                        device=device)
               for _ in range(replicas)]
    tickets = [engines[b % replicas].submit(prompt[b], gen=gen)
               for b in range(batch)]
    for eng in engines:
        eng.run()
    tokens = torch.from_numpy(np.stack([t.result(60.0) for t in tickets]))

    merged = [c for eng in engines for c in eng.call_log]
    stats = _stats_from_log(merged, tokens_total=batch * gen)
    stats["replicas"] = replicas
    stats["static_state_bytes"] = sum(e.static_state_bytes for e in engines)
    stats["decode_graphs"] = [
        {"warmup_ms": e.decode_graph.warmup_ms,
         "capture_ms": e.decode_graph.capture_ms,
         "pool_bytes": e.decode_graph.pool_bytes} for e in engines]
    StructuredLogger(log_fn=log_fn, sink=sink).log(
        "serve.done",
        f"[serve] warm-up {stats['warmup_s']*1e3:.0f} ms, "
        f"steady {stats['tok_per_s_steady']:.1f} tok/s "
        f"({stats['tok_per_s']:.1f} end-to-end)",
        batch=batch, prompt_len=prompt_len, gen=gen, device=str(device),
        **stats)
    return tokens, stats


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--replicas", type=int, default=1,
                    help="engines on the one device, lanes split across "
                         "them (no sharding)")
    ap.add_argument("--metrics", default=None, metavar="PATH",
                    help="write structured serve stats as JSONL to PATH")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where to run (default: the card; raises without "
                         "one)")
    args = ap.parse_args(argv)

    cfg = reduced(get_arch(args.arch))
    sink = MetricsSink(args.metrics) if args.metrics else None
    try:
        tokens, stats = serve(cfg, batch=args.batch,
                              prompt_len=args.prompt_len, gen=args.gen,
                              temperature=args.temperature,
                              replicas=args.replicas, sink=sink,
                              device=args.device)
    finally:
        if sink is not None:
            sink.close()
    print(f"[serve] generated {tuple(tokens.shape)} tokens; stats={stats}")


if __name__ == "__main__":
    main()
